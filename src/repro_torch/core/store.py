"""The in-memory data store at one shard: ``mgetsuffix`` (paper §IV, Redis).

The device half of ``repro.core.store``.  The corpus stays resident on the
card and requests carry indexes only; ``mget_window`` routes a batch of
(row, offset) requests to the owner shard, gathers the K-token windows there
(the ``window_gather`` kernel under ``cfg.use_pallas``) and returns them, or
the already-packed key words under ``server_pack``.

``serve_windows`` is what the pipeline calls: the same service at one shard,
but it gathers and packs only the served rows, a bounded chunk at a time, so
a round over 201 M suffixes never holds a window per capacity slot.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.config import SAConfig
from repro_torch.core import encoding
from repro_torch.core.distributed import bucket_scatter, exchange
from repro_torch.core.types import WORD_BITS

# Most requests whose windows are gathered at once by serve_windows.
FETCH_CHUNK = 1 << 22


def index_request_bytes(num_items: int, stride_bits: int) -> int:
    """Modeled bytes of one suffix-index request: int31 words carried in
    int32 lanes, one while the address space fits 31 bits, two beyond
    (``repro.core.store.index_request_bytes``)."""
    bits = max(1, (max(num_items - 1, 1)).bit_length() + stride_bits)
    return 4 * -(-bits // WORD_BITS)


@dataclass(frozen=True)
class StoreSpec:
    """Static layout of the store (one shard in this slice)."""

    num_shards: int
    rows_per_shard: int  # reads mode: rows; text mode: tokens
    row_len: int  # L (reads) or 1 (text)
    request_capacity: int  # per-destination capacity

    @property
    def is_text(self) -> bool:
        return self.row_len == 1

    @property
    def index_bytes(self) -> int:
        stride = 0 if self.is_text else int(math.ceil(math.log2(self.row_len + 1)))
        return index_request_bytes(self.num_shards * self.rows_per_shard, stride)


@dataclass
class FetchStats:
    """Per-call effective/padded byte counters (int64 device scalars)."""

    requests: torch.Tensor
    request_bytes: torch.Tensor
    response_bytes: torch.Tensor
    padded_request_bytes: int
    padded_response_bytes: int
    dropped: torch.Tensor


def token_bytes(vocab_size: int) -> int:
    """Bytes per raw token for footprint accounting (paper counts chars)."""
    return max(1, (max(vocab_size, 1).bit_length() + 7) // 8)


def _response_bytes(cfg: SAConfig, k: int) -> int:
    """Effective bytes of one response: packed words or raw tokens."""
    if cfg.server_pack:
        return 4 * cfg.key_words
    return k * token_bytes(cfg.vocab_size)


def _fetch_stats(n_ok, dropped, spec: StoreSpec, cfg: SAConfig,
                 k: int) -> FetchStats:
    per_resp = _response_bytes(cfg, k)
    cap = spec.num_shards * spec.request_capacity
    n_ok = n_ok.long()
    return FetchStats(
        requests=n_ok,
        request_bytes=n_ok * spec.index_bytes,
        response_bytes=n_ok * per_resp,
        padded_request_bytes=cap * 8,
        padded_response_bytes=cap * per_resp,
        dropped=dropped.long(),
    )


def _gather(local_rows, local_row, off, spec: StoreSpec, cfg: SAConfig, k: int):
    """Owner-side window gather of local (row, offset) requests."""
    if spec.is_text:
        return _text_window(local_rows.reshape(-1), local_row, off, k)
    if cfg.use_pallas:
        from repro_torch.kernels import ops as kops  # the mgetsuffix kernel

        return kops.window_gather(local_rows, local_row, off, k)
    return encoding.window_at(local_rows, local_row, off, k)


def mget_window(
    local_rows: torch.Tensor,
    row_id: torch.Tensor,
    offset: torch.Tensor,
    active: torch.Tensor,
    spec: StoreSpec,
    cfg: SAConfig,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, FetchStats]:
    """Batched window fetch ("mgetsuffix") at one shard.

    The contract of ``repro.core.store.mget_window``: requests are bucketed
    by owner with ``request_capacity`` slots per owner, the owner gathers a
    window for every slot, and responses are routed back by slot.
    Returns (win_or_words, exhausted, ok, stats): (M, K) windows or
    (M, key_words) packed words under ``cfg.server_pack``; ``exhausted`` is
    True where the window ran past the suffix end or the request was not
    served; ``ok`` is False for inactive requests and capacity drops.
    """
    k = window or cfg.prefix_len
    d, cap = spec.num_shards, spec.request_capacity
    if d != 1:
        raise NotImplementedError("mget_window across shards is ROADMAP.md item 10")

    owner = torch.where(active, torch.div(row_id, spec.rows_per_shard,
                                          rounding_mode="floor"), d)
    owner = owner.clamp(0, d).to(torch.int32)  # inactive -> dump bucket d
    reqs = torch.stack([torch.where(active, row_id, -1),
                        torch.where(active, offset, 0)], dim=1)
    buf, slot, _ = bucket_scatter(reqs, owner, d + 1, cap, fill=-1)
    dropped = torch.sum(active & (slot >= d * cap))

    recv = exchange(buf[:d])
    req_row = recv[..., 0].reshape(-1)
    req_off = recv[..., 1].reshape(-1).contiguous()
    local_row = torch.where(req_row >= 0, req_row, -1).contiguous()
    windows = _gather(local_rows, local_row, req_off, spec, cfg, k)
    exhausted_w = torch.any(windows == 0, dim=-1)
    payload = encoding.pack_words(windows, cfg) if cfg.server_pack else windows
    resp_width = payload.shape[1]
    payload = torch.cat([payload, exhausted_w[:, None].to(torch.int32)], dim=1)

    flatresp = exchange(payload.reshape(d, cap, resp_width + 1))
    flatresp = flatresp.reshape(d * cap, resp_width + 1)
    guard = torch.zeros((1, resp_width + 1), dtype=flatresp.dtype,
                        device=flatresp.device)
    flatresp = torch.cat([flatresp, guard], dim=0)
    back = flatresp[slot.long().clamp(0, d * cap)]
    ok = active & (slot < d * cap)
    out = torch.where(ok[:, None], back[:, :resp_width], 0)
    exhausted = torch.where(ok, back[:, resp_width] > 0, True)
    return out, exhausted, ok, _fetch_stats(torch.sum(ok), dropped, spec, cfg, k)


def serve_windows(
    local_rows: torch.Tensor,
    row_id: torch.Tensor,
    offset: torch.Tensor,
    active: torch.Tensor,
    spec: StoreSpec,
    cfg: SAConfig,
    chunk: int = FETCH_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, FetchStats]:
    """:func:`mget_window` at one shard, gathering only the served rows.

    Which requests are served is decided over the whole batch first, as
    ``bucket_scatter`` routes them: active requests owned by shard 0 are
    served in array order up to ``request_capacity``; every other active
    request is a drop.  The served rows are then gathered and packed in
    chunks of at most ``chunk`` requests.

    Returns (words, exhausted, ok, stats): (M, key_words) packed key words
    of the served windows (0 elsewhere, which is also what packing
    ``mget_window``'s zeroed raw responses gives), and ``exhausted``, ``ok``
    and stats exactly as one :func:`mget_window` call gives them.
    """
    k = cfg.prefix_len
    if spec.num_shards != 1:
        raise NotImplementedError("mget_window across shards is ROADMAP.md item 10")
    m = row_id.shape[0]
    dev = row_id.device
    owned = active & (row_id < spec.rows_per_shard)
    ok = owned & (torch.cumsum(owned, 0) <= spec.request_capacity)
    words = torch.zeros((m, cfg.key_words), dtype=torch.int32, device=dev)
    exhausted = torch.ones((m,), dtype=torch.bool, device=dev)
    served = torch.nonzero(ok).squeeze(1)
    for lo in range(0, served.shape[0], chunk):
        idx = served[lo : lo + chunk]
        win = _gather(local_rows, row_id[idx], offset[idx], spec, cfg, k)
        exhausted[idx] = torch.any(win == 0, dim=-1)
        words[idx] = encoding.pack_words(win, cfg)
        del win
    n_ok = torch.tensor(served.shape[0], device=dev)
    dropped = torch.sum(active) - n_ok
    return words, exhausted, ok, _fetch_stats(n_ok, dropped, spec, cfg, k)


def _text_window(flat: torch.Tensor, local_pos: torch.Tensor, off: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Text-mode window gather from a flat local token shard (0-padded)."""
    n = flat.shape[0]
    padded = torch.nn.functional.pad(flat, (0, k))
    pos = torch.where(local_pos >= 0, local_pos + off, n).clamp(0, n).long()
    cols = (pos[:, None] + torch.arange(k, device=flat.device)[None, :]).clamp(
        0, n + k - 1)
    return padded[cols]
