"""Multi-column sorts over order-key lanes — the counterpart of
spark_rapids_tpu/ops/sort.py for fixed-width and string columns.

The JAX package maps a column to an unsigned lane (u8/u16/u32/u64) that
sorts ascending in value order. PyTorch has no shifts, remainders or
min/max for unsigned 32- and 64-bit tensors on every device, so the port
carries the same lane in an int64 tensor ("signed order lane"):
  * lanes of at most 32 bits hold the unsigned value itself (0..2^w-1);
  * 64-bit lanes hold the unsigned value with its top bit flipped,
    which makes signed int64 order equal the unsigned order.
Both are exact encodings of the JAX lane: comparisons, min/max and the
bucket hash (ops/maskedagg._bucket_hash) give the same answers.

A string orders by `string_words` 8-byte lanes of its first bytes, big
endian and zero-padded (`string_prefix_lanes`), so that unsigned lane
order is UTF-8 binary order and a string sorts before its extensions;
each lane is a signed order lane (the u64 with its top bit flipped).
Its byte length follows as one more lane (`string_order_lanes`): zero
padding alone ties strings that differ only by trailing NUL bytes ("ab"
and "ab\0"), which Spark orders shorter first and groups apart. The JAX
package has no such lane and ties them (ROADMAP C.5).
`string_words_for` picks a word count that covers the longest string
(one host read), which makes the order exact; callers that pass no
`string_words` get that count.

`jax.lax.sort` takes many key lanes at once; torch.sort takes one. So
`lexsort` packs neighbouring narrow lanes into one int64 word while their
widths fit in 63 bits, and runs stable sorts from the last word to the
first. Starting from the identity permutation, stability makes the row
index the final tie-break: the JAX package's trailing iota key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.column import Column, StringColumn

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)

#: fewest 8-byte words of string prefix used as sort lanes (32 bytes
#: cover TPC-H's and TPC-DS's key domains)
DEFAULT_STRING_WORDS = 4


def lane_bits(torch_dtype: torch.dtype) -> int:
    """Width of the JAX package's unsigned order lane for a data dtype."""
    if torch_dtype == torch.bool:
        return 32
    return torch.empty((), dtype=torch_dtype).element_size() * 8


def lane_neutral_min(bits: int) -> int:
    """The lane's largest value (JAX: iinfo(lane dtype).max)."""
    return INT64_MAX if bits == 64 else (1 << bits) - 1


def lane_neutral_max(bits: int) -> int:
    """The lane's smallest value (JAX: zero of the lane dtype)."""
    return INT64_MIN if bits == 64 else 0


def _float_order_bits(data: torch.Tensor) -> torch.Tensor:
    """IEEE-754 total order with Spark semantics (all NaNs collapse to one
    value greater than +inf; -0.0 == 0.0) as a signed order lane."""
    nan = torch.full((), float("nan"), dtype=data.dtype, device=data.device)
    data = torch.where(torch.isnan(data), nan, data)
    data = torch.where(data == 0, torch.zeros_like(data), data)
    if data.dtype == torch.float64:
        bits = data.view(torch.int64)
        # u = bits as unsigned; order lane = neg ? ~u : u | sign, and its
        # signed form (lane ^ sign) is bits ^ INT64_MAX for negatives and
        # bits itself otherwise
        return torch.where(bits < 0, bits ^ INT64_MAX, bits)
    bits = data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits >> 31) & 1
    return torch.where(neg == 1, ~bits & 0xFFFFFFFF, bits | 0x80000000)


def _numeric_order_key(col: Column) -> torch.Tensor:
    """Map one fixed-width column to its signed order lane (int64)."""
    data = col.data
    if data.dtype == torch.bool:
        return data.to(torch.int64)
    if data.dtype.is_floating_point:
        return _float_order_bits(data)
    bits = lane_bits(data.dtype)
    if bits == 64:
        # u = data ^ sign; signed lane = u ^ sign = data
        return data
    return data.to(torch.int64) + (1 << (bits - 1))


def numeric_order_lanes(col: Column) -> List["Lane"]:
    """A fixed-width column's order lanes: one, or for a Decimal128Column
    its two limbs (the JAX package's u64 lanes `hi ^ sign` and `lo`, here
    as signed order lanes: `hi` itself and `lo` with its top bit
    flipped)."""
    from ..columnar.column import Decimal128Column
    if isinstance(col, Decimal128Column):
        return [(col.hi.data, 64), (col.lo.data ^ INT64_MIN, 64)]
    return [(_numeric_order_key(col), lane_bits(col.data.dtype))]


@dataclass(frozen=True)
class SortOrder:
    """One ORDER BY term: column ordinal + direction + null placement.

    Spark defaults: ascending => nulls first, descending => nulls last.
    """
    ordinal: int
    ascending: bool = True
    nulls_first: bool = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.nulls_first is None:
            object.__setattr__(self, "nulls_first", self.ascending)


def string_prefix_lanes(col: StringColumn, num_words: int
                        ) -> List[torch.Tensor]:
    """The first 8 * num_words bytes of each row as big-endian u64 words,
    zero-padded, each as a signed order lane (int64)."""
    starts = col.offsets[:-1].to(torch.int64)
    lengths = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
    j = torch.arange(8, dtype=torch.int64, device=col.device)
    lanes = []
    for w in range(num_words):
        at = w * 8 + j
        pos = torch.clamp(starts[:, None] + at, 0, col.byte_capacity - 1)
        byte = torch.where(at[None, :] < lengths[:, None],
                           col.data[pos].to(torch.int64), 0)
        word = byte[:, 0]
        for b in range(1, 8):
            word = (word << 8) | byte[:, b]
        lanes.append(word ^ INT64_MIN)
    return lanes


def string_order_lanes(col: StringColumn, num_words: int) -> List["Lane"]:
    """A string's order lanes: its prefix lanes, then its byte length (32
    bits), which breaks the ties of zero padding."""
    lengths = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
    return [(v, 64) for v in string_prefix_lanes(col, num_words)] \
        + [(lengths, 32)]


def string_words_for(columns: Sequence[Column], ordinals: Sequence[int]
                     ) -> int:
    """The word count that makes string ordering exact for these columns:
    the longest string's length (one host read per string column), in
    8-byte words, rounded up to a power of two from DEFAULT_STRING_WORDS
    so that lane counts bucket like capacities."""
    words = DEFAULT_STRING_WORDS
    for i in ordinals:
        col = columns[i]
        if isinstance(col, StringColumn):
            lengths = col.offsets[1:] - col.offsets[:-1]
            need = max(1, -(-int(lengths.max()) // 8))
            while words < need:
                words *= 2
    return words


#: (lane, width): an int64 tensor holding values in [0, 2^width), or a
#: signed order lane when width is 64
Lane = Tuple[torch.Tensor, int]


def order_key_lanes(columns: Sequence[Column], orders: Sequence[SortOrder],
                    num_rows, capacity: int,
                    string_words: Optional[int] = None) -> List[Lane]:
    """The full lane stack [activity, (nulls, value lanes)*] whose
    ascending lexicographic order is the requested Spark ordering,
    inactive rows last. `string_words` None: string_words_for the
    ordered columns."""
    from .basic import active_mask
    if string_words is None:
        string_words = string_words_for(columns,
                                        [o.ordinal for o in orders])
    dev = columns[0].device if columns else num_rows.device
    act = active_mask(num_rows, capacity, dev)
    lanes: List[Lane] = [((~act).to(torch.int64), 1)]
    for o in orders:
        col = columns[o.ordinal]
        valid = col.validity & act
        # nulls_first => a null ranks 0, else 1
        null_rank = valid if o.nulls_first else ~valid
        lanes.append((null_rank.to(torch.int64), 1))
        if isinstance(col, StringColumn):
            values = string_order_lanes(col, string_words)
        else:
            values = numeric_order_lanes(col)
        for v, bits in values:
            zero = INT64_MIN if bits == 64 else 0
            v = torch.where(valid, v, torch.full((), zero, dtype=torch.int64,
                                                 device=dev))
            if not o.ascending:
                v = ~v if bits == 64 else ((1 << bits) - 1) - v
            lanes.append((v, bits))
    return lanes


def lexsort(lanes: Sequence[Lane]) -> torch.Tensor:
    """Stable permutation (int64) ordering rows by `lanes`
    lexicographically, ties by row index."""
    words: List[torch.Tensor] = []
    cur, used = None, 0
    for lane, bits in lanes:
        if bits == 64 or cur is None or used + bits > 63:
            if cur is not None:
                words.append(cur)
            cur, used = lane, bits
        else:
            cur, used = (cur << bits) | lane, used + bits
    if cur is not None:
        words.append(cur)
    n = words[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=words[0].device)
    for w in reversed(words):
        _, order = torch.sort(w[perm], stable=True)
        perm = perm[order]
    return perm


def sort_permutation(columns: Sequence[Column], orders: Sequence[SortOrder],
                     num_rows, capacity: int,
                     string_words: Optional[int] = None) -> torch.Tensor:
    """Stable sort permutation: int32 (capacity,) such that gathering by it
    yields rows in the requested order, inactive rows last."""
    return lexsort(order_key_lanes(columns, orders, num_rows, capacity,
                                   string_words)).to(torch.int32)


def sort_batch_columns(columns: Sequence[Column], orders: Sequence[SortOrder],
                       num_rows, capacity: int,
                       string_words: Optional[int] = None
                       ) -> Tuple[List[Column], torch.Tensor]:
    """Sort all columns of a batch; returns (sorted columns, permutation).
    The fixed-width columns move by one packed row gather through the
    gather engine (the JAX package carries them as extra operands of its
    sort); a string or dictionary column is gathered by the permutation
    on its own."""
    from .basic import gather_column
    from .gather import gather_rows, pack_members, rebuild_members
    from .rowpack import pack_rows, unpack_rows
    perm = sort_permutation(columns, orders, num_rows, capacity,
                            string_words)
    out: List = [None] * len(columns)
    members, where = pack_members(columns)
    if members:
        plan, imat, fmat = pack_rows(members)
        gi, gf = gather_rows(plan, imat, fmat, perm)
        rebuild_members(columns, where, unpack_rows(plan, gi, gf), out,
                        lambda k, j: gather_column(k, perm.to(torch.int32)))
    for j in [j for j, c in enumerate(out) if c is None]:
        out[j] = gather_column(columns[j], perm.to(torch.int32))
    return out, perm


def group_segment_ids(key_columns: Sequence[Column], num_rows,
                      capacity: int, string_words: Optional[int] = None):
    """For KEY-SORTED columns: (segment_ids int32 (capacity,), num_groups).

    Rows with equal keys (nulls equal, Spark GROUP BY semantics) share an
    id; ids are dense 0..num_groups-1 in sorted order; inactive rows get
    id == capacity."""
    from .basic import active_mask
    dev = key_columns[0].device
    act = active_mask(num_rows, capacity, dev)
    orders = [SortOrder(i) for i in range(len(key_columns))]
    lanes = order_key_lanes(key_columns, orders, num_rows, capacity,
                            string_words)[1:]
    boundary = torch.zeros(capacity, dtype=torch.bool, device=dev)
    for lane, _ in lanes:
        boundary |= lane != torch.roll(lane, 1)
    boundary[0] = True
    boundary &= act
    seg = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    num_groups = torch.where(
        torch.as_tensor(num_rows, device=dev) > 0,
        torch.max(torch.where(act, seg, -1)) + 1, 0).to(torch.int32)
    seg = torch.where(act, seg, capacity)
    return seg, num_groups
