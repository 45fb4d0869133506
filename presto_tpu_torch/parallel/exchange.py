"""The exchange data plane: rows moved between the workers of a mesh.

Counterpart of presto_tpu/parallel/exchange.py (`_row_hash`,
`_map_block`, `exchange_by_hash`, `_route_rows`, `exchange_by_range`,
`broadcast_build`, `gather_to_root`). The reference runs these inside
`shard_map`, where one `all_to_all` or `all_gather` moves every
worker's slots. Here a mesh is one controller over a tuple of devices
(parallel/mesh.py): each function takes the list of per-worker batches,
worker w's on its own device, and returns a new list, one batch per
worker, each on its receiver's device. The rows each worker receives,
and where they sit in its batch, are the reference's:

* hash routing sends a row to worker `row_hash(keys) % n` (the
  reference's unsigned modulo); an inactive row goes nowhere;
* every sender packs its rows into `n` send slots of `slot_capacity`
  rows in row order, and receiver j's batch is every sender's slot j,
  one after another in sender order (capacity `n * slot_capacity`);
  a bucket larger than its slot keeps its first `slot_capacity` rows
  and sets the sender's overflow flag;
* a replicated batch is every worker's batch, one after another.

Each function that routes returns, beside the batches, the overflow
flag of every sender as a bool vector on the first worker's device.
Every block kind moves: flat lanes, strings as their (N, W) bytes,
128-bit lanes, arrays, maps and rows; a dictionary is decoded first.
`row_hash` and `bucket_of` also serve grouped execution and the spilled
join (exec/streaming.py, exec/spill.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..block import (Batch, Block, DictionaryColumn, RowColumn,
                     StringColumn, concat_batches, decoded, gather_block,
                     pad_chars)
from ..expr.functions import combine_hash, hash64_block
from ..ops.keys import SIGN

__all__ = ["row_hash", "bucket_of", "map_block", "move_batch",
           "slice_batch", "exchange_by_hash", "exchange_by_range",
           "broadcast_build", "gather_to_root", "RECEIVED"]

# When a list, every exchange appends (kind, [active rows received by
# each worker as a 0-d device tensor]); None (the default) records
# nothing and adds no work.
RECEIVED: Optional[list] = None


def row_hash(cols: Sequence[Block]) -> torch.Tensor:
    """Per-row hash of a key tuple: each column's hash64_block (a
    dictionary decoded first), folded left with combine_hash. It equals
    the reference's `_row_hash` bit for bit, as int64 bit patterns of
    its uint64 lanes."""
    h = None
    for c in cols:
        hc = hash64_block(decoded(c))
        h = hc if h is None else combine_hash(h, hc)
    return h


def bucket_of(h: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """The hash's unsigned 64-bit value modulo `n_buckets` (< 2^31), as
    the reference's `h % uint64(n)`: the int64 pattern splits into its
    high and low 32-bit halves, each non-negative."""
    hi = (h >> 32) & 0xFFFFFFFF
    lo = h & 0xFFFFFFFF
    return ((hi % n_buckets) * ((1 << 32) % n_buckets)
            + lo % n_buckets) % n_buckets


def map_block(b: Block, fn: Callable[[torch.Tensor], torch.Tensor]) -> Block:
    """`b` with `fn` applied to every per-row tensor (axis 0 is the
    row), a dictionary decoded first: the reference's `_map_block`."""
    b = decoded(b)
    if isinstance(b, RowColumn):
        return RowColumn(tuple(map_block(f, fn) for f in b.fields),
                         fn(b.nulls), b.type)
    return dataclasses.replace(b, **{
        f.name: fn(getattr(b, f.name)) for f in dataclasses.fields(b)
        if f.name != "type"})


def move_batch(b: Batch, device: torch.device) -> Batch:
    """`b` on `device` (the same tensors where it is there already)."""
    if b.active.device == device:
        return b
    return Batch(tuple(map_block(c, lambda t: t.to(device))
                       for c in b.columns), b.active.to(device))


def slice_batch(b: Batch, start: int, stop: int,
                device: torch.device) -> Batch:
    """Rows [start, stop) of `b` on `device` (views where they are there
    already); a dictionary keeps its whole dictionary."""
    def cut(t):
        return t[start:stop].to(device)

    def block(c):
        if isinstance(c, DictionaryColumn):
            return DictionaryColumn(
                cut(c.indices), map_block(c.dictionary,
                                          lambda t: t.to(device)),
                cut(c.nulls), c.type)
        return map_block(c, cut)
    return Batch(tuple(block(c) for c in b.columns), cut(b.active))


def any_flag(flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """The OR of boolean flags that may lie on several devices, on the
    first one's."""
    dev = flags[0].device
    return torch.stack([f.reshape(-1).any().to(dev) for f in flags]).any()


def _overflow_vector(flags: Sequence[torch.Tensor]) -> torch.Tensor:
    dev = flags[0].device
    return torch.stack([f.reshape(()).to(dev) for f in flags])


def _record(kind: str, out: Sequence[Batch]) -> None:
    if RECEIVED is not None:
        RECEIVED.append((kind, [b.active.sum() for b in out]))


def _route_rows(batches: Sequence[Batch], dests: Sequence[torch.Tensor],
                slot_capacity: int) -> Tuple[List[Batch], torch.Tensor]:
    """The shared data plane of the hash and range exchanges. `dests[i]`
    is sender i's int64 destination per row in [0, n], n meaning
    dropped. Sender i orders its rows by destination, stably (the
    reference's sort of (dest, row)); the r-th row bound for worker j
    goes to slot position r of its slot j when r < slot_capacity.
    Receiver j's batch is every sender's slot j in sender order, moved
    to receiver j's device. Only the slots are built: no sender
    materialises its whole `n * slot_capacity` send buffer."""
    n = len(batches)
    slot = int(slot_capacity)
    sorted_rows = []  # per sender: its row order and each bucket's start
    flags = []
    for dest in dests:
        perm = torch.sort(dest, stable=True).indices
        starts = torch.searchsorted(
            dest[perm].contiguous(),
            torch.arange(n + 1, dtype=dest.dtype, device=dest.device))
        flags.append((starts[1:] - starts[:-1] > slot).any())
        sorted_rows.append((perm, starts))
    out = []
    for j, recv in enumerate(batches):
        parts = []
        for b, (perm, starts) in zip(batches, sorted_rows):
            if not b.capacity:  # a sender without rows fills no slot
                parts.append(move_batch(b, recv.active.device))
                continue
            pos = torch.arange(slot, dtype=torch.int64, device=perm.device)
            ok = pos < starts[j + 1] - starts[j]
            idx = perm[(starts[j] + pos).clamp(max=b.capacity - 1)]
            part = Batch(tuple(gather_block(c, idx, ok) for c in b.columns),
                         ok)
            parts.append(move_batch(part, recv.active.device))
        out.append(concat_batches(parts) if n > 1 else parts[0])
    return out, _overflow_vector(flags)


def exchange_by_hash(batches: Sequence[Batch], key_channels: Sequence[int],
                     slot_capacity: int) -> Tuple[List[Batch], torch.Tensor]:
    """All-to-all repartition by key hash: receiver j gets every active
    row whose keys hash to j (HashPartitionFunction; workers see
    disjoint key sets). Returns the receivers' batches, each of
    capacity n * slot_capacity, and the senders' overflow flags."""
    n = len(batches)
    dests = []
    for b in batches:
        d = bucket_of(row_hash([b.column(c) for c in key_channels]), n)
        dests.append(torch.where(b.active, d, n))
    out, ovf = _route_rows(batches, dests, slot_capacity)
    _record("hash", out)
    return out, ovf


def _padded_keys(batches: Sequence[Batch], sort_keys) -> List[List[Block]]:
    """Per worker, the sort-key columns with every string key padded to
    the widest worker's width, so that every worker's key words count
    alike."""
    cols = [[decoded(b.column(k[0])) for k in sort_keys] for b in batches]
    for ki in range(len(sort_keys)):
        if isinstance(cols[0][ki], StringColumn):
            w = max(c[ki].max_len for c in cols)
            for c in cols:
                c[ki] = pad_chars(c[ki], w)
    return cols


_SAMPLES_PER_WORKER = 64


def exchange_by_range(batches: Sequence[Batch], sort_keys,
                      slot_capacity: int) -> Tuple[List[Batch], torch.Tensor]:
    """Sampled range repartition by `sort_keys` ((channel, descending,
    nulls_last) triples): worker d receives the d-th key range, so a
    sort on each worker afterwards orders the whole result (the mesh
    lowering of the MERGE exchange). Each worker draws 64 evenly
    spaced keys from its active rows in key
    order (all ones where it has none); the n - 1 splitters are every
    n-th key of all workers' samples sorted together; a row goes to the
    number of splitters it is not below, comparing key words
    lexicographically. Rows with equal keys land on one worker. No
    randomness: the rows each worker receives are the reference's."""
    from ..ops.sort import _column_words, lex_permutation
    n = len(batches)
    s = _SAMPLES_PER_WORKER
    all_words, samples = [], []
    for b, cols in zip(batches, _padded_keys(batches, sort_keys)):
        words: List[torch.Tensor] = []
        for col, (_, desc, nulls_last) in zip(cols, sort_keys):
            words.extend(w ^ SIGN for w in _column_words(col, desc,
                                                         nulls_last))
        all_words.append(words)
        dev = b.active.device
        full = torch.full((s,), (1 << 63) - 1, dtype=torch.int64, device=dev)
        if not b.capacity:
            samples.append([full] * len(words))
            continue
        order = lex_permutation([(~b.active).to(torch.int64)] + words)
        count = b.active.sum()
        pos = ((torch.arange(s, dtype=torch.int64, device=dev) * 2 + 1)
               * count) // (2 * s)
        pos = order[pos.clamp(0, b.capacity - 1)]
        samples.append([torch.where(count > 0, w[pos], full) for w in words])
    dev0 = batches[0].active.device
    gathered = [torch.cat([smp[k].to(dev0) for smp in samples])
                for k in range(len(samples[0]))]
    gorder = lex_permutation(gathered)
    spos = torch.arange(s, n * s, s, device=dev0)
    splitters = [w[gorder][spos] for w in gathered]  # each (n - 1,)
    dests = []
    for b, words in zip(batches, all_words):
        dev = b.active.device
        ge = torch.ones((n - 1, b.capacity), dtype=torch.bool, device=dev)
        for w_r, w_s in zip(reversed(words), reversed(splitters)):
            r, sv = w_r[None, :], w_s.to(dev)[:, None]
            ge = (r > sv) | ((r == sv) & ge)
        d = ge.sum(dim=0)
        dests.append(torch.where(b.active, d, n))
    out, ovf = _route_rows(batches, dests, slot_capacity)
    _record("range", out)
    return out, ovf


def _replicate(batches: Sequence[Batch]) -> List[Batch]:
    """Every worker's rows, one after another, on each worker's device
    (built once per distinct device)."""
    built = {}
    out = []
    for b in batches:
        dev = b.active.device
        if dev not in built:
            built[dev] = concat_batches([move_batch(x, dev) for x in batches])
        out.append(built[dev])
    return out


def broadcast_build(batches: Sequence[Batch]) -> List[Batch]:
    """Replicate a (typically small) build side to every worker: the
    FIXED_BROADCAST_DISTRIBUTION analog, the reference's all_gather.
    Each output has capacity n * capacity."""
    out = _replicate(batches)
    _record("broadcast", out)
    return out


def gather_to_root(batches: Sequence[Batch]) -> List[Batch]:
    """Every worker's rows on every worker: the SINGLE_DISTRIBUTION
    output stage. As in the reference, each worker holds the whole
    copy; the lowering keeps it active on worker 0 alone."""
    out = _replicate(batches)
    _record("gather", out)
    return out
