"""Cross-worker HTTP exchange: the page pull that feeds a fragment.

Counterpart of presto_tpu/server/http_exchange.py
(PrestoExchangeSource.cpp, operator/ExchangeClient.java:255): pull
every page of each upstream task over the token/ack protocol, decode
the SerializedPages, and stage the rows as one batch on the consuming
worker's device, padded to `pad_multiple`. A SORTED upstream's task
streams are k-way merged on the host (`merge_permutation`, the
MergeOperator analog).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import failpoints
from .. import types as T
from ..block import Batch, batch_from_numpy
from ..serde import PageCodec
from .client import WorkerClient

__all__ = ["fetch_remote_batch", "merge_permutation"]


def merge_permutation(arrays: Sequence[np.ndarray],
                      nulls: Sequence[np.ndarray],
                      merge_keys: Sequence[Sequence]) -> np.ndarray:
    """The permutation that k-way merges concatenated sorted runs by
    (channel, descending, nulls_last) keys (MergeOperator.java:45).
    Each key column becomes dense int64 rank codes with its direction
    and NULL placement folded in; np.lexsort's stable mergesort over a
    concatenation of sorted runs is the k-way merge, and its stability
    keeps the upstream task order of equal keys."""
    n = len(arrays[0]) if arrays else 0
    cols = []
    for ch, desc, nulls_last in merge_keys:
        # np.unique sorts NaN last: Presto's NaN-largest rule
        _, inv = np.unique(arrays[ch], return_inverse=True)
        inv = inv.astype(np.int64) + 1
        if desc:
            inv = -inv
        null_code = np.int64(1 << 40) if nulls_last else np.int64(-(1 << 40))
        cols.append(np.where(nulls[ch], null_code, inv))
    # np.lexsort's LAST key is the primary one
    return np.lexsort(tuple(reversed(cols))) if cols \
        else np.arange(n, dtype=np.int64)


def fetch_remote_batch(sources: Sequence[str], task_ids: Sequence[str],
                       types: Sequence[T.Type],
                       codec: PageCodec = PageCodec(),
                       timeout: float = 60.0,
                       pad_multiple: int = 8,
                       buffer_id: int = 0,
                       ack: bool = True,
                       merge_keys: Optional[Sequence[Sequence]] = None,
                       device=None, stats: Optional[Dict] = None) -> Batch:
    """Every page of `task_ids[i]` at worker `sources[i]`, one after
    another, as one batch on `device` (CUDA unless named): the input
    of a RemoteSourceNode. Each upstream task is waited for first; one
    that did not finish fails the pull. With `merge_keys` the upstream
    streams are sorted runs and are merged by those keys. `codec` is
    the producers' (the session's exchange_compression). `stats`, if
    given, gains the pages and page bytes pulled and the seconds spent
    decoding them."""
    if failpoints.ARMED:
        # an injected error here is a consumer-side upstream failure:
        # the task fails and the coordinator's resubmission takes over
        failpoints.hit("exchange.fetch")
    all_cols: List[List[np.ndarray]] = [[] for _ in types]
    all_nulls: List[List[np.ndarray]] = [[] for _ in types]
    total = 0
    for base, tid in zip(sources, task_ids):
        client = WorkerClient(base, timeout=timeout)
        info = client.wait(tid, timeout=timeout)
        if info["state"] != "FINISHED":
            # an upstream failure fails the consumer: never a partial
            # result
            raise RuntimeError(f"upstream task {tid} at {base} is "
                               f"{info['state']}: {info.get('error')}")
        cols = client.fetch_results(tid, types, codec, buffer_id=buffer_id,
                                    ack=ack)
        if stats is not None:
            stats["pages_in"] = stats.get("pages_in", 0) + \
                client.pulled["pages"]
            stats["page_bytes_in"] = stats.get("page_bytes_in", 0) + \
                client.pulled["bytes"]
            stats["decode_s"] = stats.get("decode_s", 0.0) + \
                client.pulled["decode_s"]
        total += len(cols[0][0]) if cols else 0
        for c, (v, m) in enumerate(cols):
            if len(v):  # an empty page's default dtype would leak in
                all_cols[c].append(v)
                all_nulls[c].append(m)
    arrays, nulls = [], []
    for c, ty in enumerate(types):
        if all_cols[c]:
            arrays.append(np.concatenate(all_cols[c]))
            nulls.append(np.concatenate(all_nulls[c]))
        else:
            arrays.append(np.array([], dtype=object if ty.is_string
                                   else ty.to_dtype()))
            nulls.append(np.array([], dtype=bool))
    if merge_keys and total:
        perm = merge_permutation(arrays, nulls, merge_keys)
        arrays = [a[perm] for a in arrays]
        nulls = [m[perm] for m in nulls]
    cap = max(-(-total // pad_multiple) * pad_multiple, pad_multiple)
    return batch_from_numpy(types, arrays, nulls, capacity=cap,
                            device=device)
