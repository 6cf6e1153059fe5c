"""Build entry point that picks single-pass or out-of-core construction.

Only the single-pass branch of ``repro.core.superblock.build_suffix_array_auto``
is ported.  A plan that needs more than one superblock, an LCP array or an
index manifest raises ``NotImplementedError``: that is ROADMAP.md item 9.
"""
from __future__ import annotations

import numpy as np

from repro_torch.config import SAConfig
from repro_torch.core.pipeline import build_suffix_array
from repro_torch.core.types import SAResult


def num_superblocks(corpus_shape, sb) -> int:
    """Superblock count of ``repro.core.superblock.plan_superblocks``.

    ``sb`` is any object with ``num_superblocks`` and
    ``max_records_per_run`` (such as a ``repro.config.SuperblockConfig``);
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
    return max(1, min(s, items))


def build_suffix_array_auto(
    corpus,
    lengths=None,
    cfg: SAConfig = SAConfig(),
    sb=None,
    device=None,
) -> SAResult:
    """Single-pass build when the record set fits one run (the launcher's
    policy).  ``corpus`` is an in-memory array; ``device`` as for
    :func:`repro_torch.core.pipeline.build_suffix_array`."""
    if not isinstance(corpus, np.ndarray):
        raise NotImplementedError(
            "chunked-file and store-backend corpora are ROADMAP.md item 8")
    wants_index = sb is not None and (getattr(sb, "emit_lcp", False)
                                      or getattr(sb, "write_manifest", False))
    if num_superblocks(corpus.shape, sb) > 1 or wants_index:
        raise NotImplementedError(
            "out-of-core superblocks, LCP and index manifests are "
            "ROADMAP.md item 9")
    return build_suffix_array(corpus, lengths=lengths, cfg=cfg, device=device)

