"""Numeric prefix encoding (paper §IV-B, "structural scalability").

The port of ``repro.core.encoding``: tokens are int32 in ``[1, V]`` with
``0`` as the ``$`` delimiter / padding; a key is ``key_words`` int31 words,
each packing ``chars_per_word`` tokens base-(V+1) or by bit shifts, both
order-preserving.  Arithmetic is int32 and wraps exactly as jnp's does.

The Map-phase encoders never build a ``(·, K)`` window tensor: word ``w`` is
a multiply-accumulate over ``cpw`` shifted slices of the zero-padded tokens,
which is what the ``prefix_pack`` kernel does (``kernels/csrc/prefix_pack.cu``).
At 201 M suffixes the window tensor alone would take 20.9 GB.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import SAConfig
from repro_torch.core.types import KEY_SENTINEL, pack_index


def _pack(column: Callable[[int], torch.Tensor], cfg: SAConfig,
          n_words: int) -> torch.Tensor:
    """Pack token columns into key words: ``column(j)`` is token j of every
    window.  Returns ``column(0).shape + (n_words,)`` int32."""
    cpw = cfg.resolved_chars_per_word()
    bits = max(1, int(cfg.vocab_size).bit_length())
    words = []
    for w in range(n_words):
        acc = column(w * cpw).to(torch.int32).clone()
        for j in range(w * cpw + 1, (w + 1) * cpw):
            tok = column(j)
            if cfg.packing == "base":
                acc.mul_(cfg.vocab_size + 1).add_(tok)
            else:
                acc.bitwise_left_shift_(bits).bitwise_or_(tok)
        if cfg.packing != "base":
            # left-align so shorter-filled words still compare correctly;
            # a shift outside [0, 32) gives 0, as in XLA
            shift = 31 - bits * cpw
            if 0 <= shift < 32:
                acc.bitwise_left_shift_(shift)
            else:
                acc.zero_()
        words.append(acc)
    return torch.stack(words, dim=-1)


def pack_words(window: torch.Tensor, cfg: SAConfig,
               n_words: int | None = None) -> torch.Tensor:
    """(..., K) int32 token windows -> (..., n_words) int32 key words."""
    cpw = cfg.resolved_chars_per_word()
    n_words = cfg.key_words if n_words is None else n_words
    k = cpw * n_words
    assert window.shape[-1] == k, (tuple(window.shape), k)
    return _pack(lambda j: window[..., j], cfg, n_words)


def pack_shifted(tokens: torch.Tensor, m: int, cfg: SAConfig) -> torch.Tensor:
    """Key words of the K-token windows starting at positions ``0..m-1`` of
    ``tokens`` (zero past its end), from K shifted slices.  (m, key_words)."""
    padded = F.pad(tokens, (0, max(0, m + cfg.prefix_len - tokens.shape[0])))
    return _pack(lambda j: padded[j : j + m], cfg, cfg.key_words)


def unpack_words_np(words: np.ndarray, cfg: SAConfig) -> np.ndarray:
    """Inverse of :func:`pack_words` (numpy, for tests)."""
    cpw = cfg.resolved_chars_per_word()
    out = []
    for w in range(cfg.key_words):
        acc = words[..., w].astype(np.int64)
        toks = []
        if cfg.packing == "base":
            for _ in range(cpw):
                toks.append(acc % (cfg.vocab_size + 1))
                acc //= cfg.vocab_size + 1
            toks.reverse()
        else:
            bits = max(1, int(cfg.vocab_size).bit_length())
            acc >>= 31 - bits * cpw
            for _ in range(cpw):
                toks.append(acc & ((1 << bits) - 1))
                acc >>= bits
            toks.reverse()
        out.extend(toks)
    return np.stack(out, axis=-1).astype(np.int32)


def window_at(reads: torch.Tensor, row: torch.Tensor, offset: torch.Tensor,
              k: int) -> torch.Tensor:
    """Gather k-token windows ``reads[row, offset:offset+k]`` (0-padded).

    reads: (R, L) int32.  row/offset: (M,).  Returns (M, k) int32.  Rows
    outside ``[0, R)`` give zeros; offsets are clamped to ``[0, L]``.  The
    plain version of the ``window_gather`` kernel; it indexes the corpus in
    place instead of copying a padded corpus as the jnp version does.
    """
    r, l = reads.shape
    m = row.shape[0]
    if r * l == 0:
        return torch.zeros((m, k), dtype=torch.int32, device=reads.device)
    row = row.long()
    cols = offset.long().clamp(0, l)[:, None] + torch.arange(
        k, device=reads.device)[None, :]
    valid = ((row >= 0) & (row < r))[:, None] & (cols < l)
    flat = row.clamp(0, r - 1)[:, None] * l + cols.clamp(max=l - 1)
    return torch.where(valid, reads.reshape(-1)[flat], 0)


def all_suffix_windows(reads: torch.Tensor, k: int) -> torch.Tensor:
    """(R, L) reads -> (R, L+1, k) windows for offsets 0..L (incl. $-suffix)."""
    _, l = reads.shape
    padded = F.pad(reads, (0, k))
    cols = (torch.arange(l + 1, device=reads.device)[:, None]
            + torch.arange(k, device=reads.device)[None, :])
    return padded[:, cols]


def suffix_words(reads: torch.Tensor, n_words: int, cfg: SAConfig) -> torch.Tensor:
    """(R, L) reads -> (R, L+1, n_words) key words of every suffix's first
    ``n_words * chars_per_word`` tokens, zero past the read's end: what
    ``pack_words(all_suffix_windows(reads, n_words * cpw), cfg, n_words)``
    gives, from shifted slices, without the (R, L+1, K) window tensor."""
    _, l = reads.shape
    padded = F.pad(reads, (0, n_words * cfg.resolved_chars_per_word()))
    return _pack(lambda j: padded[:, j : j + l + 1], cfg, n_words)


def make_records_reads(
    reads: torch.Tensor,
    lengths: torch.Tensor,
    cfg: SAConfig,
    read_id_base: int = 0,
    stride_bits: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map phase over a shard of reads: every suffix -> 16-byte record.

    Returns (records, valid):
      records: (R*(L+1), 4) int32 [key_hi, key_lo, idx_hi, idx_lo]
      valid:   (R*(L+1),) bool — offset <= length (invalid slots carry
               KEY_SENTINEL keys and sort to the end)
    """
    r, l = reads.shape
    if stride_bits == 0:
        stride_bits = int(np.ceil(np.log2(l + 1)))
    dev = reads.device
    padded = F.pad(reads, (0, cfg.prefix_len))  # (R, L+K)
    keys = _pack(lambda j: padded[:, j : j + l + 1], cfg, cfg.key_words)
    offs = torch.arange(l + 1, dtype=torch.int32, device=dev)
    valid = offs[None, :] <= lengths[:, None]  # (R, L+1)
    rows = torch.arange(r, dtype=torch.int32, device=dev)[:, None] + read_id_base
    idx_hi, idx_lo = pack_index(
        rows.expand(r, l + 1), offs[None, :].expand(r, l + 1), stride_bits)
    key_hi = torch.where(valid, keys[..., 0], KEY_SENTINEL)
    key_lo = torch.where(valid, keys[..., 1], KEY_SENTINEL)
    del keys
    rec = torch.stack([key_hi, key_lo, idx_hi, idx_lo], dim=-1)
    return rec.reshape(r * (l + 1), 4), valid.reshape(-1)


def make_records_text(
    text: torch.Tensor,
    cfg: SAConfig,
    pos_base: int = 0,
    n_emit: int | None = None,
) -> torch.Tensor:
    """Long-text mode map phase: (n,) tokens -> (n_emit, 4) records.

    Global index = absolute position; windows past the end 0-pad, which
    orders shorter suffixes first on equal prefixes.  In the pipeline
    ``text`` is the shard plus its right halo and ``n_emit`` the shard length.
    """
    m = text.shape[0] if n_emit is None else n_emit
    keys = pack_shifted(text, m, cfg)
    pos = torch.arange(m, dtype=torch.int32, device=text.device) + pos_base
    idx_hi = torch.zeros((m,), dtype=torch.int32, device=text.device)
    return torch.stack([keys[:, 0], keys[:, 1], idx_hi, pos], dim=-1)
