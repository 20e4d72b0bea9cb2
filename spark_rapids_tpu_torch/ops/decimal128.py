"""Two-limb decimal128 arithmetic — the counterpart of
spark_rapids_tpu/ops/decimal128.py.

A 128-bit unscaled value is two int64 lanes: `hi` carries the high 64
bits with the sign, `lo` the low 64 bits reinterpreted as signed.

    value = hi * 2^64 + (lo as unsigned)

The JAX module computes in uint64. PyTorch has no add, compare or shift
for uint64 tensors on the CPU, so every limb operation here stays in
int64, whose adds and multiplies wrap mod 2^64 exactly as uint64's do:

  * an unsigned compare flips both sign bits first (`_ult`);
  * a logical right shift masks off the sign fill of `>>` (`_lsr`);
  * products go through 32-bit halves held in int64 (`_mul_u64`), as the
    JAX module's own `_U32` halves do.

The results are the JAX module's bit for bit, the overflow flags too
(tests/test_torch_decimal128.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

_U32 = 0xFFFFFFFF
_MIN = -(1 << 63)

#: saturation sentinel for overflowed decimal sums: i128 max, beyond every
#: legal decimal(38) value, so it arises only from saturation and the
#: any-input-saturated check keeps it sticky
SAT_HI = (1 << 63) - 1
SAT_LO = -1


def _i64(v: int) -> int:
    """A host integer's low 64 bits as a signed int64 value."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _ult(a, b):
    """Unsigned a < b of int64 lanes."""
    return (a ^ _MIN) < (b ^ _MIN)


def _lsr(x, k: int):
    """Logical right shift of int64 lanes by k in [0, 63]."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def from_i64(v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign-extend an int64 unscaled value to (hi, lo)."""
    return v >> 63, v


def add128(h1, l1, h2, l2):
    lo = l1 + l2
    carry = _ult(lo, l1)
    return h1 + h2 + carry.to(torch.int64), lo


def neg128(h, l):
    lo = ~l + 1
    return ~h + (lo == 0).to(torch.int64), lo


def sub128(h1, l1, h2, l2):
    nh, nl = neg128(h2, l2)
    return add128(h1, l1, nh, nl)


def is_neg(h):
    return h < 0


def abs128(h, l):
    nh, nl = neg128(h, l)
    neg = is_neg(h)
    return torch.where(neg, nh, h), torch.where(neg, nl, l)


def cmp128(h1, l1, h2, l2):
    """-1 / 0 / +1 as int32 (signed 128-bit compare)."""
    lt = (h1 < h2) | ((h1 == h2) & _ult(l1, l2))
    gt = (h1 > h2) | ((h1 == h2) & _ult(l2, l1))
    return gt.to(torch.int32) - lt.to(torch.int32)


def _mul_u64(a, b):
    """u64 x u64 -> (hi, lo) via u32 half-limbs; each partial product
    wraps mod 2^64 as the JAX module's uint64 products do."""
    a0, a1 = a & _U32, _lsr(a, 32)
    b0, b1 = b & _U32, _lsr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = _lsr(p00, 32) + (p01 & _U32) + (p10 & _U32)
    lo = (p00 & _U32) | (mid << 32)
    hi = p11 + _lsr(p01, 32) + _lsr(p10, 32) + _lsr(mid, 32)
    return hi, lo


def mul_i64_i64(a, b):
    """Signed 64 x 64 -> exact signed 128 (hi, lo)."""
    sign = (a < 0) ^ (b < 0)
    ua = torch.where(a < 0, -a, a)
    ub = torch.where(b < 0, -b, b)
    hi, lo = _mul_u64(ua, ub)
    nh, nl = neg128(hi, lo)
    return torch.where(sign, nh, hi), torch.where(sign, nl, lo)


def mul128_u64(h, l, m):
    """(h, l) * unsigned 64-bit m -> (hi, lo, overflowed). Sign-aware:
    operates on |x| then restores the sign."""
    neg = is_neg(h)
    ah, al = abs128(h, l)
    if not isinstance(m, torch.Tensor):
        m = torch.full_like(h, _i64(int(m)))
    hi_lo, lo = _mul_u64(al, m)            # low limb product
    hi2_hi, hi2_lo = _mul_u64(ah, m)       # high limb product
    hi = hi_lo + hi2_lo
    over = (hi2_hi != 0) | _ult(hi, hi2_lo) | (hi < 0)
    nh, nl = neg128(hi, lo)
    return torch.where(neg, nh, hi), torch.where(neg, nl, lo), over


def _divmod_u32(h, l, d):
    """Unsigned (h, l) divided by a divisor d < 2^31 (an int or a lane):
    schoolbook long division over four u32 digits."""
    digits = [_lsr(h, 32), h & _U32, _lsr(l, 32), l & _U32]
    r = torch.zeros_like(h)
    q = []
    for dig in digits:
        cur = (r << 32) | dig   # < d * 2^32 <= 2^63: non-negative
        q.append(torch.div(cur, d, rounding_mode="floor"))
        r = torch.remainder(cur, d)
    qh = (q[0] << 32) | q[1]
    ql = (q[2] << 32) | q[3]
    return qh, ql, r


def _pow10_steps(k: int):
    """Split 10^k into factors < 2^31 (each <= 10^9)."""
    out = []
    while k > 0:
        s = min(k, 9)
        out.append(s)
        k -= s
    return out


def divmod_pow10(h, l, k: int):
    """Signed (h, l) // 10^k, k in [0, 38], truncated toward zero. Returns
    (qh, ql, last_rem, last_half): the staged division's final remainder
    decides HALF_UP exactly (rem_total >= 10^k/2 iff the most significant
    stage's remainder >= its own half)."""
    if not 0 <= k <= 38:
        raise ValueError(f"10^{k} is past decimal128")
    if k == 0:
        return h, l, torch.zeros_like(h), 1
    neg = is_neg(h)
    ah, al = abs128(h, l)
    r = torch.zeros_like(h)
    last = 1
    for step in _pow10_steps(k):
        d = 10 ** step
        ah, al, r = _divmod_u32(ah, al, d)
        last = d
    nh, nl = neg128(ah, al)
    return torch.where(neg, nh, ah), torch.where(neg, nl, al), r, last // 2


def rescale(h, l, from_scale: int, to_scale: int):
    """Unscaled rescale with Spark HALF_UP rounding on scale reduction.
    Returns (hi, lo, overflowed)."""
    no = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    if to_scale == from_scale:
        return h, l, no
    if to_scale > from_scale:
        over = no
        for step in _pow10_steps(to_scale - from_scale):
            h, l, o = mul128_u64(h, l, 10 ** step)
            over = over | o
        return h, l, over
    qh, ql, rem, half = divmod_pow10(h, l, from_scale - to_scale)
    # HALF_UP: round away from zero when |rem| >= half
    bump = rem >= half
    neg = is_neg(h)
    one = torch.ones_like(h)
    zero = torch.zeros_like(h)
    bh, bl = add128(qh, ql, torch.where(neg & bump, -one, zero),
                    torch.where(bump, torch.where(neg, -one, one), zero))
    return bh, bl, no


def pow10_128(k: int) -> Tuple[int, int]:
    """(hi, lo) host ints of 10^k for overflow bounds."""
    v = 10 ** k
    return v >> 64, v & ((1 << 64) - 1)


def fits_precision(h, l, precision: int):
    """|value| < 10^precision (the non-ANSI overflow -> NULL check)."""
    ah, al = abs128(h, l)
    bh, bl = pow10_128(precision)
    return cmp128(ah, al, torch.full_like(h, _i64(bh)),
                  torch.full_like(l, _i64(bl))) < 0


def divmod128_u64(h, l, d):
    """Unsigned (h, l) // d for a lane divisor d < 2^63. Returns (qh, ql,
    rem). The high limb divides natively (h < 2^63 at every call site:
    it is a magnitude); the (rem, lo) double word divides by 64 binary
    steps, with unsigned compares since rem << 1 may pass 2^63."""
    qh = torch.div(h, d, rounding_mode="floor")
    r = torch.remainder(h, d)
    ql = torch.zeros_like(l)
    for i in range(63, -1, -1):
        bit = _lsr(l, i) & 1
        r = (r << 1) | bit
        ge = ~_ult(r, d)
        r = torch.where(ge, r - d, r)
        ql = ql | torch.where(ge, torch.full_like(ql, _i64(1 << i)),
                              torch.zeros_like(ql))
    return qh, ql, r


def div128_round_half_up(h, l, d):
    """Signed (h, l) / signed i64 d (nonzero), HALF_UP rounding."""
    neg = is_neg(h) ^ (d < 0)
    ah, al = abs128(h, l)
    ad = torch.where(d < 0, -d, d)
    qh, ql, r = divmod128_u64(ah, al, ad)
    bump = ~_ult(r * 2, ad)
    qh, ql = add128(qh, ql, torch.zeros_like(qh), bump.to(torch.int64))
    nh, nl = neg128(qh, ql)
    return torch.where(neg, nh, qh), torch.where(neg, nl, ql)


def shl128(h, l, k: int):
    """Logical left shift of (h, l) by k in [0, 63]."""
    if k == 0:
        return h, l
    return (h << k) | _lsr(l, 64 - k), l << k


def limb16_lanes(h, l):
    """Eight u16 limbs (as int64 lanes, low first) of the unsigned 128-bit
    representation. Summing each lane exactly in int64 (bounded by
    2^16 * rows) and recombining gives the exact 128-bit sum with plain
    segment sums."""
    out = []
    for src in (l, h):
        for k in range(4):
            out.append(_lsr(src, 16 * k) & 0xFFFF)
    return out


def _add192(a2, a1, a0, b2, b1, b0):
    lo = a0 + b0
    c0 = _ult(lo, a0).to(torch.int64)
    mid = a1 + b1 + c0
    c1 = (_ult(mid, a1) | ((c0 == 1) & (mid == a1))).to(torch.int64)
    return a2 + b2 + c1, mid, lo


def combine_limb_sums(sums):
    """Recombine eight per-limb int64 sums into (hi, lo) mod 2^128."""
    rh, rl = combine_limb_sums_checked(sums)[:2]
    return rh, rl


def combine_limb_sums_checked(sums, neg_count=None):
    """(hi, lo, overflowed): exact 192-bit accumulation of the shifted
    limb sums, so that a true sum past +-2^127 is detected instead of
    aliasing back into range mod 2^128. Every negative input inflates the
    192-bit total by exactly 2^128; `neg_count` (per-slot count of
    negative summed values) corrects the top limb before the
    fits-signed-128 test. None disables the check."""
    t2 = torch.zeros_like(sums[0])
    t1 = torch.zeros_like(sums[0])
    t0 = torch.zeros_like(sums[0])
    for k, s in enumerate(sums):
        bits = 16 * k
        # sign-extend s to 3 limbs, then shift left by `bits` (< 128)
        s2, s1, s0 = s >> 63, s >> 63, s
        if bits and bits < 64:
            s2, s1, s0 = ((s2 << bits) | _lsr(s1, 64 - bits),
                          (s1 << bits) | _lsr(s0, 64 - bits), s0 << bits)
        elif bits == 64:
            s2, s1, s0 = s1, s0, torch.zeros_like(s0)
        elif bits > 64:
            nb = bits - 64
            s2, s1, s0 = ((s1 << nb) | _lsr(s0, 64 - nb), s0 << nb,
                          torch.zeros_like(s0))
        t2, t1, t0 = _add192(t2, t1, t0, s2, s1, s0)
    if neg_count is None:
        return t1, t0, torch.zeros(t1.shape, dtype=torch.bool,
                                   device=t1.device)
    # fits signed 128 iff (after removing the unsigned-representation
    # inflation) the top limb is the sign extension of the mid limb
    over = (t2 - neg_count) != (t1 >> 63)
    return t1, t0, over


def saturate_sum(rh, rl, over, any_sat):
    """Decimal-sum overflow semantics: past signed 128 (or fed by an
    already-saturated partial) the slot pins to the SAT sentinel, which
    fails fits_precision at evaluate -> NULL."""
    bad = over | any_sat
    return (torch.where(bad, torch.full_like(rh, SAT_HI), rh),
            torch.where(bad, torch.full_like(rl, SAT_LO), rl))


def is_saturated(h, l):
    return (h == SAT_HI) & (l == SAT_LO)


def _segment_sum(values, seg, n: int):
    """(n,) sums of `values` by segment id; ids outside [0, n) drop."""
    idx = torch.where((seg >= 0) & (seg < n), seg, n).long()
    out = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, idx, values)
    return out[:n]


def decimal_segment_sum(col, valid_mask, seg, capacity: int):
    """Exact 128-bit segment sum of a decimal column (either tier): eight
    u16-limb int64 segment sums recombined with 192-bit overflow
    detection and sticky saturation; segment ids outside [0, capacity)
    drop. Returns ((hi, lo) (capacity,) limb lanes, has_any bool lane)."""
    from .maskedagg import _decimal_limbs
    h, l = _decimal_limbs(col)
    zero = torch.zeros((), dtype=torch.int64, device=h.device)
    sums = [_segment_sum(torch.where(valid_mask, lane, zero), seg, capacity)
            for lane in limb16_lanes(h, l)]
    negs = _segment_sum(((h < 0) & valid_mask).to(torch.int64), seg,
                        capacity)
    rh, rl, over = combine_limb_sums_checked(sums, negs)
    sat = _segment_sum((is_saturated(h, l) & valid_mask).to(torch.int64),
                       seg, capacity) > 0
    counts = _segment_sum(valid_mask.to(torch.int64), seg, capacity)
    return saturate_sum(rh, rl, over, sat), counts > 0


def to_f64(h, l):
    """The value as a double: hi * 2^64 + unsigned lo, the low limb
    converted with one rounding (its top 53 bits exactly, then the rest)."""
    ulo = _lsr(l, 11).to(torch.float64) * 2048.0 \
        + (l & 2047).to(torch.float64)
    return h.to(torch.float64) * (2.0 ** 64) + ulo


def fits_i64(h, l):
    """Is the value representable in one int64 limb?"""
    return h == (l >> 63)
