"""Build entry point that picks single-pass or out-of-core construction.

The port of ``repro.core.superblock``'s entry points.  Only the single-block
path is ported: an in-core build, then the post-hoc LCP array under
``sb.emit_lcp``.  A plan of more than one superblock, ``resume``,
``sanitize``, ``store_retries`` and ``REPRO_SANITIZE`` raise
``NotImplementedError`` naming ROADMAP.md item 9; index manifests, spill
directories and chunked corpora name item 8.  The JAX wrapper runs its
phases under a background executor; this one runs them in order, which
gives the same result.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from repro_torch.config import SAConfig, SuperblockConfig
from repro_torch.core.lcp import lcp_from_sa
from repro_torch.core.pipeline import build_suffix_array
from repro_torch.core.store import (
    CorpusStore,
    InMemoryBackend,
    StoreBackend,
    materialize_backend,
)
from repro_torch.core.types import SAResult

# LCP pairs compared at once on the card (the default of ``lcp_from_sa`` on
# the CPU); the single-block build's LCP store is discarded, so the batch
# changes no reported number
CUDA_LCP_BATCH = 1 << 22


def num_superblocks(corpus_shape, sb) -> int:
    """Superblock count of ``repro.core.superblock.plan_superblocks``: the
    number of blocks after the block size is rounded up to whole items.

    ``sb`` is any object with ``num_superblocks`` and
    ``max_records_per_run`` (a ``SuperblockConfig`` of either package);
    ``None`` means single-pass.
    """
    if sb is None:
        return 1
    if len(corpus_shape) == 1:
        items, per_item = corpus_shape[0], 1
    else:
        items, per_item = corpus_shape[0], corpus_shape[1] + 1
    if sb.num_superblocks > 0:
        s = sb.num_superblocks
    elif sb.max_records_per_run > 0:
        items_fit = sb.max_records_per_run // per_item
        s = -(-items // items_fit) if items_fit >= 1 else items
    else:
        s = 1
    s = max(1, min(s, items))
    per_block = -(-items // s)
    return -(-items // per_block) if items else 1


def _refuse_unported(sb) -> None:
    if sb.write_manifest or sb.spill_dir is not None or sb.store_backend != "memory":
        raise NotImplementedError(
            "index manifests, spill directories and the chunked store "
            "backend are ROADMAP.md item 8")
    if (sb.resume or sb.sanitize or sb.store_retries > 0
            or os.environ.get("REPRO_SANITIZE", "") not in ("", "0")):
        raise NotImplementedError(
            "resume, the sanitizer and store retries are ROADMAP.md item 9")


def build_suffix_array_superblock(
    corpus,
    lengths=None,
    cfg: SAConfig = SAConfig(),
    sb: SuperblockConfig = SuperblockConfig(),
    device=None,
) -> SAResult:
    """The single-block path of ``repro``'s out-of-core wrapper.

    ``corpus`` is an array or a :class:`StoreBackend`; ``device`` places an
    array's backend (the card by default) and the build runs there.  The
    build's store stages the corpus for one in-core run, then serves the
    post-hoc LCP when ``sb.emit_lcp`` is set.
    """
    if isinstance(corpus, (str, os.PathLike)):
        raise NotImplementedError("chunked corpus files are ROADMAP.md item 8")
    _refuse_unported(sb)
    if isinstance(corpus, StoreBackend):
        backend = corpus
    else:
        backend = InMemoryBackend(np.asarray(corpus, np.int32), cfg, device=device)
    if num_superblocks(backend.shape, sb) > 1:
        raise NotImplementedError(
            "builds of more than one superblock are ROADMAP.md item 9")
    store = CorpusStore(None, cfg, backend=backend,
                        request_capacity=sb.request_capacity)
    res = build_suffix_array(store.stage_items(0, backend.n), lengths=lengths,
                             cfg=cfg, device=backend.device)
    if sb.emit_lcp and res.lcp is None:
        batch = CUDA_LCP_BATCH if backend.device.type == "cuda" else 1 << 16
        res.lcp = lcp_from_sa(store, res.suffix_array, batch=batch)
        res.stats["emit_lcp"] = True
    return res


def build_suffix_array_auto(
    corpus,
    lengths=None,
    cfg: SAConfig = SAConfig(),
    sb: Optional[SuperblockConfig] = None,
    device=None,
) -> SAResult:
    """Single-pass build when the record set fits one run (the launcher's
    policy); a plan of more blocks, an LCP array or a manifest goes through
    :func:`build_suffix_array_superblock`, as in ``repro``.  ``device`` as
    for :func:`repro_torch.core.pipeline.build_suffix_array`."""
    sb = sb or SuperblockConfig()
    if isinstance(corpus, (str, os.PathLike)):
        raise NotImplementedError("chunked corpus files are ROADMAP.md item 8")
    shape = corpus.shape if isinstance(corpus, StoreBackend) else np.shape(corpus)
    if num_superblocks(shape, sb) <= 1 and not (sb.emit_lcp or sb.write_manifest):
        if isinstance(corpus, StoreBackend):
            corpus = materialize_backend(corpus)
        return build_suffix_array(corpus, lengths=lengths, cfg=cfg, device=device)
    return build_suffix_array_superblock(corpus, lengths=lengths, cfg=cfg, sb=sb,
                                         device=device)
