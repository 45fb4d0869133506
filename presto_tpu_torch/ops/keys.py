"""Key normalization: columns -> order-preserving 64-bit key words.

Counterpart of presto_tpu/ops/keys.py. The reference builds uint64
words whose unsigned lexicographic order is the SQL order of the key
tuple and whose equality is key equality. Torch cannot compare uint64,
so each word here is the int64 tensor with the same bits: equality is
unchanged, and ordering code compares `word ^ SIGN` (ops/sort.py).

* integers, dates, timestamps, short decimals: one word, the value
  with its sign bit flipped (a zoned timestamp: its instant); booleans:
  one word, 0 or 1; doubles: one word, the IEEE bits with the sign
  flipped (negative values complemented), -0.0 as 0.0, NaN above +inf;
* varchar/char: big-endian packed 8-byte chunks, zero padded;
* NULL: a leading null word per column; value words are zeroed under
  null, so NULL keys compare equal (GROUP BY semantics).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from ..block import Block, Column, Int128Column, StringColumn, decoded

SIGN = -(1 << 63)  # int64 bit pattern of the reference's uint64 1 << 63

__all__ = ["key_words", "string_words", "double_bits", "SIGN"]

# The float64 -> int64 bit cast as an op of its own, with a vmap rule
# that casts the tensor under the member axis: Tensor.view(dtype) has no
# vmap rule in every torch this port runs on, and a template that casts
# a double key (exec/batching.py's torch.func.vmap) must not fail there.
_LIB = torch.library.Library("presto_tpu_torch", "FRAGMENT")
_LIB.define("double_bits(Tensor x) -> Tensor")


def _double_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64).clone()  # an op's output aliases no input


for _key in ("CPU", "CUDA"):
    _LIB.impl("double_bits", _double_bits, _key)


@torch.library.register_fake("presto_tpu_torch::double_bits")
def _double_bits_fake(x):
    # W001: a double's 64 bits are the key word's contract
    return torch.empty_like(x, dtype=torch.int64)  # tpulint: disable=W001


torch.library.register_vmap(
    "presto_tpu_torch::double_bits",
    lambda info, in_dims, x: (double_bits(x), in_dims[0]))


def double_bits(x: torch.Tensor) -> torch.Tensor:
    """A float64 tensor's IEEE bits as int64, under torch.func.vmap too."""
    if x.dtype != torch.float64:
        raise TypeError(f"double_bits takes float64, got {x.dtype}")
    return torch.ops.presto_tpu_torch.double_bits(x)


def _fixed_words(col: Column) -> List[torch.Tensor]:
    v = col.values
    if col.type.base == "timestamp with time zone":
        # order and equality on the instant: the same micros in two
        # zones are the same SQL value
        v = v.to(torch.int64) >> 12
    if v.dtype == torch.bool:
        return [v.to(torch.int64)]
    if v.is_floating_point():
        f = v.to(torch.float64)
        bits = double_bits(torch.where(f == 0.0, 0.0, f))
        w = torch.where(bits < 0, ~bits, bits ^ SIGN)
        return [torch.where(torch.isnan(f), -1, w)]  # NaN: all ones
    return [v.to(torch.int64) ^ SIGN]


def string_words(col: StringColumn) -> List[torch.Tensor]:
    n, w = col.chars.shape
    padded = torch.nn.functional.pad(col.chars, (0, (-w) % 8))
    nwords = padded.shape[1] // 8
    chunks = padded.reshape(n, nwords, 8).to(torch.int64)
    shifts = 8 * (7 - torch.arange(8, dtype=torch.int64,
                                   device=chunks.device))
    # big-endian per chunk; the shifted bytes occupy disjoint bits, so
    # the sum is their bitwise or
    words = (chunks << shifts).sum(dim=2)
    return [words[:, i] for i in range(nwords)]


def key_words(cols: Sequence[Block],
              nulls_last: Union[bool, Sequence[bool]] = False
              ) -> List[torch.Tensor]:
    """For each column its null-order word followed by its value words."""
    if isinstance(nulls_last, bool):
        nulls_last = [nulls_last] * len(cols)
    words: List[torch.Tensor] = []
    for col, nl in zip(cols, nulls_last):
        col = decoded(col)
        isnull = col.nulls
        words.append(torch.where(isnull, int(nl), int(not nl)))
        if isinstance(col, StringColumn):
            vws = string_words(col)
        elif isinstance(col, Int128Column):
            vws = [col.hi ^ SIGN, col.lo]
        else:
            vws = _fixed_words(col)
        for vw in vws:
            words.append(torch.where(isnull, 0, vw))
    return words
