"""Small-codomain gather / scatter helpers (port of
``ovo_tpu/ops/segment_mxu.py``).

The JAX package wrote these as chunked one-hot matmuls because TPU gathers
and scatters run a row at a time (its PERF.md finding 1). On the GPU they
are plain index ops; results are bit-equal to the matmul forms, including
the out-of-range contracts:

  table_lookup      out[i] = table[idx[i]]          (0 when out of range)
  table_lookup_int  the same for int32 tables of 16-bit values
  histogram         out[t] = #{i : idx[i] == t}     (out of range dropped)
  segment_or        out[t] = OR_i {rows[i] : idx[i] == t}

None of them synchronizes with the host.
"""
from __future__ import annotations

from typing import Optional

import torch


def _in_range(idx: torch.Tensor, n: int) -> torch.Tensor:
    """idx as int64 with every out-of-range entry sent to the sentinel n."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))


def table_lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]] for idx in [0, T); out-of-range rows return 0.
    table: (T,) or (T, C), f32 or int32. A float table's -0.0 reads back as
    +0.0, as the one-hot product's sum does."""
    squeeze = table.ndim == 1
    tbl = table[:, None] if squeeze else table
    T = tbl.shape[0]
    ext = torch.cat([tbl, tbl.new_zeros((1,) + tbl.shape[1:])])
    out = ext.index_select(0, _in_range(idx, T).reshape(-1)).reshape(
        idx.shape + tbl.shape[1:])
    if out.is_floating_point():
        out = out + 0.0
    return out[..., 0] if squeeze else out


def table_lookup_int(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]] for idx in [0, T); out-of-range rows return 0.
    table: (T,) or (T, C) int32 with values in (-32768, 32767]. Like the
    reference's hi/lo byte split, a table value of -32768 (outside that
    contract) reads back as 0."""
    T = table.shape[0]
    tbl = table.to(torch.int32)
    tbl = torch.where(tbl == -32768, torch.zeros_like(tbl), tbl)
    ext = torch.cat([tbl, tbl.new_zeros((1,) + tbl.shape[1:])])
    return ext.index_select(0, _in_range(idx, T).reshape(-1)).reshape(
        idx.shape + tbl.shape[1:])


def histogram(idx: torch.Tensor, n_bins: int,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[t] = sum of weights (default 1) where idx == t, t in [0, n_bins);
    out-of-range indices dropped. f32 output (counts exact below 2^24)."""
    flat = _in_range(idx, n_bins).reshape(-1)
    if weights is None:
        out = torch.zeros(n_bins + 1, dtype=torch.int32, device=idx.device)
        out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    else:
        out = torch.zeros(n_bins + 1, dtype=torch.float32, device=idx.device)
        out.index_add_(0, flat, weights.float().reshape(-1))
    return out[:n_bins].float()


def segment_or(idx: torch.Tensor, rows: torch.Tensor, n_segments: int
               ) -> torch.Tensor:
    """out[t] = OR of rows[i] where idx[i] == t. rows: (N, ...) bool, idx:
    (N,); out-of-range rows dropped. -> (n_segments, ...) bool."""
    cnt = torch.zeros((n_segments + 1,) + rows.shape[1:], dtype=torch.int32,
                      device=rows.device)
    cnt.index_add_(0, _in_range(idx, n_segments), rows.to(torch.int32))
    return cnt[:n_segments] > 0
