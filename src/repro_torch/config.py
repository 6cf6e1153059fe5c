"""Configuration of the port: the suffix-array pipeline and the LM archs.

Copies of ``repro.config.SAConfig`` and ``repro.config.SuperblockConfig``
with the same fields, defaults and derived values
(``tests/test_torch_config.py`` holds them together).
``use_pallas`` keeps its name: in the port it selects the hand-written
CUDA kernels instead of their plain PyTorch versions.

The LM side: copies of ``AttentionConfig``, ``MoEConfig``, ``SSMConfig`` and
``ArchConfig`` with their derived methods, and the ``--arch`` registry
(``register_arch``, ``get_arch``, ``list_archs``), which imports
``repro_torch.configs`` on first use as ``repro``'s imports
``repro.configs`` (``tests/test_torch_lm_configs.py`` holds every
registered config to ``repro``'s field for field).  ``scan_layers`` and
``remat`` are kept for the configs' sake; the port runs its layers eagerly
and ignores both.

The training and serving side: copies of ``ShapeConfig`` with
``LM_SHAPES``, ``MeshConfig``, ``ShardingPolicy``, ``TrainConfig`` and
``ServeConfig``, field for field (``tests/test_torch_lm_configs.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    """Attention block configuration (GQA/MQA/SWA/local:global)."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    # Sliding window size for *local* layers. ``None`` => full attention.
    sliding_window: Optional[int] = None
    # Pattern of local (``L``) / global (``G``) layers, tiled over depth.
    # ``"G"`` => all-global; gemma3 uses ``"LLLLLG"`` (5:1).
    layer_pattern: str = "G"
    # Soft cap on attention logits (gemma-style); 0 disables.
    logit_softcap: float = 0.0
    qk_norm: bool = False

    def window_for_layer(self, layer: int, seq_len: int) -> int:
        """Effective window for ``layer`` (full == seq_len)."""
        kind = self.layer_pattern[layer % len(self.layer_pattern)]
        if kind == "L" and self.sliding_window is not None:
            return min(self.sliding_window, seq_len)
        return seq_len

    def is_global_layer(self, layer: int) -> bool:
        return self.layer_pattern[layer % len(self.layer_pattern)] == "G" or (
            self.sliding_window is None
        )


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts configuration (None on dense archs)."""

    num_experts: int
    top_k: int
    expert_ffn_dim: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # "tp" / "ep": how a mesh would shard the experts (kept for the
    # configs; one card shards nothing)
    sharding: str = "tp"


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent block configuration (xLSTM, Mamba-style)."""

    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    # xlstm: pattern of "m" (mLSTM) / "s" (sLSTM) blocks tiled over depth.
    block_pattern: str = "m"
    chunk_size: int = 64


@dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig]
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # tokens | embeddings (audio/vlm frontends feed precomputed embeddings)
    input_mode: str = "tokens"
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"  # silu => SwiGLU, gelu => plain GeLU MLP
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # compile policies of the JAX package; the port accepts and ignores them
    scan_layers: bool = True
    remat: str = "nothing_saveable"  # none | nothing_saveable | dots_saveable
    # sequence-chunked cross entropy: never materialize full (B,S,V) logits
    loss_chunk: int = 0  # 0 = off
    # flash-style online-softmax attention over KV blocks (no S x S scores)
    attn_chunk: int = 0  # 0 = off
    # decode caches sized to each layer's window (local:global aware)
    window_decode_cache: bool = False
    # source provenance string from the assignment table
    source: str = ""
    notes: str = ""

    def qkv_dims(self) -> Tuple[int, int]:
        a = self.attention
        return a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim

    def param_count(self) -> int:
        """Total parameter count (used for 6ND model-flops)."""
        d, l, v = self.d_model, self.num_layers, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        per_layer = 0
        if self.attention is not None:
            q, kv = self.qkv_dims()
            per_layer += d * q + 2 * d * kv + q * d  # q,k,v,o
        if self.moe is not None:
            per_layer += d * self.moe.num_experts  # router
            per_layer += self.moe.num_experts * 3 * d * self.moe.expert_ffn_dim
        elif self.d_ff > 0:
            n_mat = 3 if self.act == "silu" else 2
            per_layer += n_mat * d * self.d_ff
        if self.ssm is not None:
            s = self.ssm
            inner = s.expand * d
            # in_proj (x and z), dt/B/C projections, out_proj, conv
            per_layer += d * 2 * inner + inner * (2 * s.state_dim + 1) + inner * d
            per_layer += inner * s.conv_width
        per_layer += 2 * d  # norms
        return total + l * per_layer

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive = (m.num_experts - m.top_k) * 3 * self.d_model * m.expert_ffn_dim
        return self.param_count() - self.num_layers * inactive


# ---------------------------------------------------------------------------
# shapes, mesh and sharding policy, training and serving
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        return int(math.prod(self.shape))

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    @property
    def model_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a == "model")


@dataclass(frozen=True)
class ShardingPolicy:
    """How logical axes map onto mesh axes (with divisibility fallback)."""

    fsdp_axes: Tuple[str, ...] = ("data",)
    tp_axes: Tuple[str, ...] = ("model",)
    dp_axes: Tuple[str, ...] = ("pod", "data")
    # shard decode KV cache sequence dim over these axes (flash-decoding style)
    kv_seq_axes: Tuple[str, ...] = ("model",)
    # activations sequence-parallel axes for training (None = off)
    seq_axes: Tuple[str, ...] = ()
    moe_ep: bool = False
    # gradient reduction: "reduce_scatter" (fsdp) or "all_reduce"
    grad_reduce: str = "reduce_scatter"
    # FSDP-shard the embedding table's d_model dim; False keeps it sharded
    # on vocab only, so the logits never contract over a sharded d_model
    embed_fsdp: bool = True


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"  # cosine | wsd | constant
    warmup_steps: int = 100
    decay_steps: int = 10_000
    stable_steps: int = 0  # for WSD
    min_lr_ratio: float = 0.1
    microbatches: int = 1
    # gradient compression across DP replicas: none | int8 | topk
    grad_compression: str = "none"
    topk_ratio: float = 0.05
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    max_seq_len: int = 32_768
    max_batch: int = 128
    prefill_chunk: int = 512
    eos_id: int = 2


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs(include_tiny: bool = False) -> List[str]:
    import repro_torch.configs  # noqa: F401

    names = sorted(_REGISTRY)
    if not include_tiny:
        names = [n for n in names if not n.startswith("tiny-")]
    return names


@dataclass(frozen=True)
class SAConfig:
    """Configuration for suffix-array construction (see ``repro.config``).

    ``mode``: ``"scheme"`` (the paper's index-only shuffle with on-demand
    window fetches), ``"terasort"`` (the paper's baseline,
    ``core/terasort.py``) or ``"doubling"`` (prefix doubling over the rank
    store, ``core/prefix_doubling.py``); each mode is its own builder.
    """

    mode: str = "scheme"
    vocab_size: int = 5  # $,A,C,G,T
    # tokens packed per 31-bit key word; 0 => derive max from vocab
    chars_per_word: int = 0
    key_words: int = 2
    packing: str = "base"  # base (paper-faithful) | bits
    samples_per_shard: int = 256  # paper: 10000 per reducer
    # shuffle bucket capacity = ceil(n_local) * slack
    shuffle_slack: float = 2.0
    # per-round fetch capacity as a fraction of local records (1.0 = all)
    fetch_fraction: float = 1.0
    max_rounds: int = 0  # 0 => derive from read length
    # paper's trick: suffixes shorter than the resolved prefix are final
    skip_exhausted: bool = True
    # server-side packing: respond with packed key words (8B) instead of raw
    # token windows (K bytes).  False = paper-faithful (raw suffix windows).
    server_pack: bool = True
    sort_group_threshold: int = 1 << 20  # paper: 1.6e6
    use_pallas: bool = False  # use the hand-written CUDA kernels
    read_stride_bits: int = 0  # 0 => derive ceil(log2(L+1))
    # two-phase planning: size the shuffle capacity exactly from a bucket
    # histogram (zero drops).  False = static heuristic capacity.
    adaptive: bool = True

    def resolved_chars_per_word(self) -> int:
        if self.chars_per_word:
            return self.chars_per_word
        if self.packing == "base":
            # max k with (vocab+1)^k < 2^31   (tokens shifted to 1..vocab, 0=$)
            k, cap = 0, 1
            while cap * (self.vocab_size + 1) < (1 << 31):
                cap *= self.vocab_size + 1
                k += 1
            return k
        bits = max(1, (self.vocab_size).bit_length())
        return max(1, 31 // bits)

    @property
    def prefix_len(self) -> int:
        return self.resolved_chars_per_word() * self.key_words


@dataclass(frozen=True)
class SuperblockConfig:
    """Out-of-core superblock construction (see ``repro.config``).

    The port runs one block in core (with the post-hoc LCP array under
    ``emit_lcp``) and a plan of more blocks through any ``merge_algorithm``
    (``"merge_path"``, ``"kway"``, ``"rerank"``) on either
    ``merge_backend``, at any ``merge_tile`` and ``pipeline_depth``, with
    the LCP array emitted by the merge, on the in-memory or the chunked
    store (``store_backend``, ``chunk_records``, ``cache_budget_bytes``),
    into a ``spill_dir`` and, with ``write_manifest``, an index directory;
    ``store_retries > 0`` retries transient store faults
    (``store_backoff_s``), ``resume`` with a ``spill_dir`` journals the
    build and resumes a killed one, and ``sanitize`` runs the runtime
    sanitizer.  The fields are kept whole so a JAX run's configuration
    carries across unchanged.
    """

    max_records_per_run: int = 0
    num_superblocks: int = 0
    samples_per_block: int = 32
    request_capacity: int = 4096
    merge_algorithm: str = "merge_path"
    merge_tile: int = 0
    merge_backend: str = "host"
    store_backend: str = "memory"
    chunk_records: int = 0
    cache_budget_bytes: int = 0
    spill_dir: Optional[str] = None
    emit_lcp: bool = False
    write_manifest: bool = False
    sanitize: bool = False
    pipeline_depth: int = 1
    resume: bool = False
    store_retries: int = 0
    store_backoff_s: float = 0.01


def _from_reference(cls, d: dict):
    names = {f.name for f in fields(cls)}
    if set(d) != names:
        raise ValueError(
            f"{cls.__name__} fields differ: missing {sorted(names - set(d))}, "
            f"unknown {sorted(set(d) - names)}")
    return cls(**d)


def sa_config_from_reference(d: dict) -> SAConfig:
    """``dataclasses.asdict`` of a ``repro.config.SAConfig`` -> the port's.

    The configuration plus a numpy corpus is all the state a build has, so
    this is how a run of the JAX package is carried across.  Raises
    ``ValueError`` when the field sets differ.
    """
    return _from_reference(SAConfig, d)


def superblock_config_from_reference(d: dict) -> SuperblockConfig:
    """``dataclasses.asdict`` of a ``repro.config.SuperblockConfig`` -> the
    port's; raises ``ValueError`` when the field sets differ."""
    return _from_reference(SuperblockConfig, d)
