"""The paper's own workload as a selectable config: distributed SA
construction over the grouper-genome-scale read set (paper §I: 64 GB input,
325,718,730 reads x ~200 bp -> ~6.7 TB of suffixes).

A copy of ``repro.configs.suffix_array``.  Workloads may
carry a :class:`SuperblockConfig`; the launcher then routes through the
out-of-core superblock builder (``repro_torch.core.superblock``) whenever the
record set exceeds one run's capacity."""
from dataclasses import dataclass
from typing import Optional

from repro_torch.config import SAConfig, SuperblockConfig


@dataclass(frozen=True)
class SAWorkload:
    name: str
    num_reads: int
    read_len: int
    sa: SAConfig
    superblock: Optional[SuperblockConfig] = None


def grouper_genome() -> SAWorkload:
    """The paper's full experiment (dry-run scale)."""
    return SAWorkload(
        name="grouper-genome",
        num_reads=325_718_730,
        read_len=200,
        sa=SAConfig(vocab_size=4, packing="base", samples_per_shard=10_000),
    )


def grouper_small() -> SAWorkload:
    """CPU-runnable slice of the same distribution."""
    return SAWorkload(
        name="grouper-small",
        num_reads=2_000,
        read_len=64,
        sa=SAConfig(vocab_size=4, packing="base", samples_per_shard=256),
    )


def grouper_out_of_core() -> SAWorkload:
    """CPU-runnable out-of-core exercise: the same distribution with a
    per-run record budget that forces >= 4 superblocks, so the build goes
    through partition -> per-block pipeline -> store-mediated merge."""
    return SAWorkload(
        name="grouper-out-of-core",
        num_reads=800,
        read_len=48,
        sa=SAConfig(vocab_size=4, packing="base", samples_per_shard=256),
        superblock=SuperblockConfig(max_records_per_run=10_000),
    )
