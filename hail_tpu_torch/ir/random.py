"""Counter-based deterministic randomness: Threefry-4x64-20 + PMAC.

Reference-parity implementation of the reference's RNG design
(`hail/hail/src/is/hail/expr/ir/Random.scala:14-255`, design doc
`dev-docs/hail-query/randomness.md`):

- `threefry_encrypt` — the Threefry-4x64 block cipher, 20 rounds, with the
  reference's tweak schedule (t2 = t0 ^ t1, key injection every 4 rounds).
  Verified against the skein_golden_kat_short test vectors that the
  reference's own `RandomSuite.scala:16-30` pins.
- `pmac_hash` / `pmac` — the PMAC incremental hash over a message of 64-bit
  words (row UIDs), with the static-block nonce/staticID prefix and the
  padded/no-pad final-tweak distinction (`Random.scala:261-301`).
- `rand_doubles` — vectorized emulation of `ThreefryRandomEngine.nextDouble`
  (`Random.scala:553-572`): the "infinite-precision real rounded down"
  construction (exponent from trailing-zero count, significand from the
  next 52 bits), NOT the biased `(bits >> 11) / 2^53` ladder.

Everything is vectorized numpy over row batches: one row = one counter
(uid), so values are independent of partitioning and evaluation order —
the property the reference calls "deterministic and distributed" randomness.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

U64 = np.uint64

ROT_CONSTS = ((14, 16), (52, 57), (23, 40), (5, 37),
              (25, 33), (46, 12), (58, 22), (32, 32))

KEY_CONST = U64(0x1BD11BDAA9FC1A22)

STATIC_TWEAK = np.int64(-1).astype(U64)
FINAL_BLOCK_NO_PAD_TWEAK = np.int64(-2).astype(U64)
FINAL_BLOCK_PADDED_TWEAK = np.int64(-3).astype(U64)


def expand_key(k: Sequence[int]) -> np.ndarray:
    """4-word key -> 5-word expanded key (Random.scala:42-46)."""
    assert len(k) == 4
    k = np.asarray([U64(w & 0xFFFFFFFFFFFFFFFF) for w in k], dtype=U64)
    k4 = k[0] ^ k[1] ^ k[2] ^ k[3] ^ KEY_CONST
    return np.concatenate([k, np.asarray([k4], dtype=U64)])


DEFAULT_KEY = expand_key([0x215D6DFDB7DFDF6B, 0x045CFA043329C49F,
                          0x9EC75A93692444DD, 0x1284681663220F1C])


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    n = n & 63
    return (x << U64(n)) | (x >> U64(64 - n))


def threefry_encrypt(x: np.ndarray, tweak, key: np.ndarray = DEFAULT_KEY,
                     rounds: int = 20) -> np.ndarray:
    """Threefry-4x64 over a batch: x is (n, 4) uint64, returns (n, 4).

    `tweak` is (t0, t1) of scalars or (n,) arrays. Matches
    `Threefry.encrypt` (Random.scala:181-206) bit-for-bit.
    """
    assert key.shape == (5,)
    x = np.array(x, dtype=U64, copy=True)
    squeeze = False
    if x.ndim == 1:
        x = x[None, :]
        squeeze = True
    t0 = np.asarray(tweak[0], dtype=U64)
    t1 = np.asarray(tweak[1], dtype=U64)
    t = (t0, t1, t0 ^ t1)

    cols = [x[:, 0].copy(), x[:, 1].copy(), x[:, 2].copy(), x[:, 3].copy()]

    with np.errstate(over='ignore'):
        for d in range(rounds):
            if d % 4 == 0:
                s = d // 4
                cols[0] += key[s % 5]
                cols[1] += key[(s + 1) % 5] + t[s % 3]
                cols[2] += key[(s + 2) % 5] + t[(s + 1) % 3]
                cols[3] += key[(s + 3) % 5] + U64(s)
            r0, r1 = ROT_CONSTS[d % 8]
            cols[0] += cols[1]
            cols[1] = _rotl(cols[1], r0) ^ cols[0]
            cols[2] += cols[3]
            cols[3] = _rotl(cols[3], r1) ^ cols[2]
            cols[1], cols[3] = cols[3], cols[1]
        if rounds % 4 == 0:
            s = rounds // 4
            cols[0] += key[s % 5]
            cols[1] += key[(s + 1) % 5] + t[s % 3]
            cols[2] += key[(s + 2) % 5] + t[(s + 1) % 3]
            cols[3] += key[(s + 3) % 5] + U64(s)

    out = np.stack(cols, axis=-1)
    return out[0] if squeeze else out


def _as_u64_cols(message, n: int) -> List[np.ndarray]:
    cols = []
    for m in message:
        a = np.asarray(m)
        if a.ndim == 0:
            a = np.broadcast_to(a, (n,))
        cols.append(a.astype(np.int64).view(U64) if a.dtype.kind == 'i'
                    else a.astype(U64))
    return cols


def pmac_hash(nonce: int, static_id: int, message, n: int = None):
    """PMAC over per-row messages -> ((n,4) hash, final_tweak scalar).

    `message` is a sequence of message *words*, each a scalar or (n,) array
    (column-vectorized: row i's message is [message[0][i], message[1][i]...]).
    Mirrors `Threefry.pmacHash` (Random.scala:272-301): the nonce/staticID
    block is encrypted with the static tweak, full 4-word blocks are
    encrypted with tweak (block_start, 0) and xor-summed, and the final
    (possibly 1-padded) block is xored in raw; the caller encrypts with the
    returned final tweak.
    """
    if n is None:
        n = 1
        for m in message:
            a = np.asarray(m)
            if a.ndim:
                if a.shape[0] == 0:
                    n = 0
                    break
                n = max(n, a.shape[0])
    cols = _as_u64_cols(message, n)
    L = len(cols)
    padded_len = max((L + 3) & ~3, 4)
    padded = padded_len != L
    blocks = [np.broadcast_to(c, (n,)) for c in cols]
    if padded:
        pad = [np.full(n, U64(1) if j == L else U64(0), dtype=U64)
               for j in range(L, padded_len)]
        blocks = blocks + pad

    init = np.empty((n, 4), dtype=U64)
    init[:, 0] = U64(int(nonce) & 0xFFFFFFFFFFFFFFFF)
    init[:, 1] = U64(int(static_id) & 0xFFFFFFFFFFFFFFFF)
    init[:, 2] = 0
    init[:, 3] = 0
    s = threefry_encrypt(init, (STATIC_TWEAK, U64(0)))

    i = 0
    while i + 4 < padded_len:
        blk = np.stack(blocks[i:i + 4], axis=-1)
        enc = threefry_encrypt(blk, (U64(i), U64(0)))
        s ^= enc
        i += 4
    for j in range(4):
        s[:, j] ^= blocks[i + j]
    final_tweak = FINAL_BLOCK_PADDED_TWEAK if padded else FINAL_BLOCK_NO_PAD_TWEAK
    return s, final_tweak


def pmac(nonce: int, static_id: int, message, n: int = None) -> np.ndarray:
    """Full PMAC: hash then final encryption (Random.scala:261-265)."""
    s, ft = pmac_hash(nonce, static_id, message, n)
    return threefry_encrypt(s, (ft, U64(0)))


def _trailing_zeros(bits: np.ndarray) -> np.ndarray:
    """Vectorized count-trailing-zeros for uint64 (bits != 0)."""
    low = bits & (~bits + U64(1))          # lowest set bit (power of two)
    # a power of two is exactly representable in f64; log2 is exact
    return np.log2(low.astype(np.float64)).astype(np.int64)


def rand_doubles(hash4: np.ndarray, final_tweak) -> np.ndarray:
    """One `nextDouble()` per row from a PMAC hash state.

    Emulates ThreefryRandomEngine: buffer = encrypt(state, (tweak, counter));
    nextLong() = buffer[0]; the infinite-precision double construction
    (Random.scala:553-572). The bits==0 refill loop is carried through the
    remaining buffer words (probability 2^-64 per step; beyond the first
    buffer the contribution is below double precision and clamps to 0).
    """
    n = hash4.shape[0]
    buf = threefry_encrypt(hash4, (np.broadcast_to(np.asarray(final_tweak, U64), (n,)),
                                   U64(0)))
    bits = buf[:, 0]
    exponent = np.full(n, 1022, dtype=np.int64)
    word = np.ones(n, dtype=np.int64)       # next unread buffer word index
    for w in (1, 2, 3):
        zero = bits == 0
        if not zero.any():
            break
        bits = np.where(zero, buf[:, w], bits)
        exponent = np.where(zero, exponent - 64, exponent)
        word = np.where(zero, w + 1, word)
    # rows still zero after 4 words: value is below 2^-256 -> 0.0
    dead = bits == 0
    bits = np.where(dead, U64(1) << U64(12), bits)

    e = _trailing_zeros(bits)
    exponent = exponent - e
    # significand: current bits if e < 12, else the next long (next word;
    # rows that exhausted the buffer would refill — approximate with a
    # second encryption only if needed)
    need_next = e >= 12
    if need_next.any():
        nxt_idx = np.minimum(word, 3)
        nxt = buf[np.arange(n), nxt_idx]
        refill = word > 3
        if refill.any():
            buf2 = threefry_encrypt(hash4, (np.broadcast_to(np.asarray(final_tweak, U64), (n,)), U64(1)))
            nxt = np.where(refill, buf2[:, 0], nxt)
        sig_src = np.where(need_next, nxt, bits)
    else:
        sig_src = bits
    significand = sig_src >> U64(12)
    result = (exponent.astype(np.int64) << np.int64(52)).view(U64) | significand
    out = result.view(np.float64).copy()
    out[dead] = 0.0
    out[exponent < 0] = 0.0
    return out


def rand_unif01(nonce: int, static_id: int, message, n: int = None) -> np.ndarray:
    """Uniform [0,1) doubles, one per row: PMAC(uids) -> nextDouble."""
    s, ft = pmac_hash(nonce, static_id, message, n)
    return rand_doubles(s, ft)


def rand_int64s(nonce: int, static_id: int, message, n: int = None) -> np.ndarray:
    """Four raw 64-bit words per row (the engine's first buffer fill)."""
    s, ft = pmac_hash(nonce, static_id, message, n)
    nn = s.shape[0]
    return threefry_encrypt(s, (np.broadcast_to(np.asarray(ft, U64), (nn,)), U64(0)))


# ---------------------------------------------------------------------------
# ThreefryRandomEngine emulation (Random.scala:406-572): a per-row buffered
# stream over encrypt(state, (finalTweak, counter)); ints are consumed
# high-32-first within each 64-bit word.
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


class ScalarEngine:
    """Exact per-row engine for the rare slow paths (rejection resampling)."""

    def __init__(self, state4, final_tweak):
        self.state = np.asarray(state4, dtype=U64)
        self.tweak = U64(final_tweak)
        self.counter = 0
        self.used = 8
        self.buf = None

    def _fill(self):
        self.buf = threefry_encrypt(self.state[None, :],
                                    (self.tweak, U64(self.counter)))[0]
        self.used = 0
        self.counter += 1

    def next_int(self) -> int:
        if self.used >= 8:
            self._fill()
        result = int(self.buf[self.used >> 1])
        self.used += 1
        parity = self.used & 1
        shift = parity << 5
        return (result >> shift) & _MASK32

    def next_long(self) -> int:
        self.used += self.used & 1
        if self.used >= 8:
            self._fill()
        r = int(self.buf[self.used >> 1])
        self.used += 2
        return r

    def next_int_bounded(self, n: int) -> int:
        # Lemire-style bounded draw (Random.scala:491-508)
        mult = n * (self.next_int() & _MASK32)
        result = mult >> 32
        fraction = mult & _MASK32
        if fraction < (1 << 32) - n:
            return result
        mult_high = (((n * (self.next_int() & _MASK32)) >> 32)
                     + (n * (self.next_int() & _MASK32))) >> 32
        s = fraction + mult_high
        carry = (s >> 32) & 1
        return result + carry

    def next_long_bounded(self, l: int) -> int:
        x = (self.next_long() & ((1 << 64) - 1)) >> 1
        r = x % l
        while x - r + (l - 1) >= (1 << 63):
            x = (self.next_long() & ((1 << 64) - 1)) >> 1
            r = x % l
        return r


def map4_unif(block: np.ndarray) -> np.ndarray:
    """RandomSeededFunctions._rand_unif: an (n,4) random block -> uniform
    [0,1) doubles via the infinite-precision-bitstream construction (bits
    scanned long3..long0, significand always long0 >>> 12)."""
    n = block.shape[0]
    bits = block[:, 3].copy()
    exp = np.full(n, 1022, dtype=np.int64)
    for w in (2, 1, 0):
        zero = bits == 0
        if not zero.any():
            break
        bits = np.where(zero, block[:, w], bits)
        exp = np.where(zero, exp - 64, exp)
    dead = bits == 0
    bits = np.where(dead, U64(1), bits)
    exp = exp - _trailing_zeros(bits)
    result = (exp.astype(np.int64) << np.int64(52)).view(U64) \
        | (block[:, 0] >> U64(12))
    out = result.view(np.float64).copy()
    out[dead] = 0.0
    return out


def _rand_state(nonce: int, static_id: int, words, n: int = None):
    """PMAC the uid words -> ((n,4) engine state, final tweak)."""
    return pmac_hash(nonce, static_id, words, n)


def rand_unif_exact(nonce, static_id, words, n=None) -> np.ndarray:
    """hl.rand_unif parity: _rand_unif over rngState.rand() (the PMAC final
    encryption block)."""
    s, ft = pmac_hash(nonce, static_id, words, n)
    block = threefry_encrypt(s, (ft, U64(0)))
    return map4_unif(block)


def rand_int32_bounded(nonce, static_id, words, bound, n=None) -> np.ndarray:
    """hl.rand_int32 parity: engine nextInt(bound) per row. `bound` is a
    scalar or (n,) int array."""
    s, ft = pmac_hash(nonce, static_id, words, n)
    nrows = s.shape[0]
    block0 = threefry_encrypt(s, (ft, U64(0)))
    hi = (block0[:, 0] >> U64(32)).astype(np.int64)   # first nextInt: high 32
    b = np.broadcast_to(np.asarray(bound, dtype=np.int64), (nrows,))
    mult = b * hi
    result = (mult >> np.int64(32)).astype(np.int64)
    fraction = mult & np.int64(_MASK32)
    slow = fraction >= (np.int64(1 << 32) - b)
    if slow.any():
        for i in np.where(slow)[0]:
            result[i] = ScalarEngine(s[i], ft).next_int_bounded(int(b[i]))
    return result.astype(np.int32)


def rand_int64_full(nonce, static_id, words, n=None) -> np.ndarray:
    """hl.rand_int64() parity: engine nextLong per row."""
    s, ft = pmac_hash(nonce, static_id, words, n)
    return threefry_encrypt(s, (ft, U64(0)))[:, 0].view(np.int64).copy()


def rand_int64_bounded(nonce, static_id, words, bound, n=None) -> np.ndarray:
    """hl.rand_int64(l) parity: engine nextLong(l) per row."""
    s, ft = pmac_hash(nonce, static_id, words, n)
    nrows = s.shape[0]
    b = np.broadcast_to(np.asarray(bound, dtype=np.int64), (nrows,))
    out = np.empty(nrows, dtype=np.int64)
    block0 = threefry_encrypt(s, (ft, U64(0)))
    x = (block0[:, 0] >> U64(1)).astype(np.int64)
    r = x % b
    ok = (x - r + (b - 1)) >= 0
    out[ok] = r[ok]
    for i in np.where(~ok)[0]:
        out[i] = ScalarEngine(s[i], ft).next_long_bounded(int(b[i]))
    return out


def _long_to_double_bits(result: int) -> float:
    import struct as _struct
    return _struct.unpack('<d', _struct.pack('<Q', result & ((1 << 64) - 1)))[0]


def _scalar_next_double(eng: 'ScalarEngine') -> float:
    """Engine nextDouble (Random.scala:553-572)."""
    bits = eng.next_long() & ((1 << 64) - 1)
    exponent = 1022
    while bits == 0:
        bits = eng.next_long() & ((1 << 64) - 1)
        exponent -= 64
    e = (bits & -bits).bit_length() - 1
    exponent -= e
    significand = (bits if e < 12 else eng.next_long() & ((1 << 64) - 1)) >> 12
    return _long_to_double_bits(((exponent & 0xFFF) << 52) | significand)


ScalarEngine.next_double = _scalar_next_double


_EXPMAX = 1024 * 0.693147180559945309417232121458  # log(DBL_MAX)


def rbeta_engine(eng: 'ScalarEngine', aa: float, bb: float) -> float:
    """Beta variate via Cheng's BB/BC algorithms (R nmath rbeta.c; jdistlib
    Beta.random) consuming the engine's nextDouble stream."""
    import math
    if math.isnan(aa) or math.isnan(bb) or aa < 0.0 or bb < 0.0:
        return float('nan')
    if not math.isfinite(aa) and not math.isfinite(bb):
        return 0.5
    if aa == 0.0 and bb == 0.0:
        return 0.0 if eng.next_double() < 0.5 else 1.0
    if not math.isfinite(aa) or bb == 0.0:
        return 1.0
    if not math.isfinite(bb) or aa == 0.0:
        return 0.0

    a = min(aa, bb)
    b = max(aa, bb)
    alpha = a + b

    def v_w(AA, beta, u1):
        v = beta * math.log(u1 / (1.0 - u1))
        if v <= _EXPMAX:
            w = AA * math.exp(v)
            if not math.isfinite(w):
                w = 1.7976931348623157e308
        else:
            w = 1.7976931348623157e308
        return v, w

    if a <= 1.0:  # Algorithm BC — NOTE R swaps notation here: a = LARGER
        a = max(aa, bb)
        b = min(aa, bb)
        alpha = a + b
        beta = 1.0 / b
        delta = 1.0 + a - b
        k1 = delta * (0.0138889 + 0.0416667 * b) / (a * beta - 0.777778)
        k2 = 0.25 + (0.5 + 0.25 / delta) * b
        while True:
            u1 = eng.next_double()
            u2 = eng.next_double()
            if u1 < 0.5:
                y = u1 * u2
                z = u1 * y
                if 0.25 * u2 + z - y >= k1:
                    continue
            else:
                z = u1 * u1 * u2
                if z <= 0.25:
                    v, w = v_w(a, beta, u1)
                    break
                if z >= k2:
                    continue
            v, w = v_w(a, beta, u1)
            if alpha * (math.log(alpha / (b + w)) + v) - 1.3862944 >= math.log(z):
                break
        # tie (aa == bb): the engine reports the complement orientation
        # (pinned by rand_beta(0.5, 0.5) -> 0.30607924177641355)
        if aa != a or aa == bb:
            return b / (b + w)
        return w / (b + w)

    # Algorithm BB
    beta = math.sqrt((alpha - 2.0) / (2.0 * a * b - alpha))
    gamma = a + 1.0 / beta
    while True:
        u1 = eng.next_double()
        u2 = eng.next_double()
        v, w = v_w(a, beta, u1)
        z = u1 * u1 * u2
        r = gamma * v - 1.3862944
        s = a + r - w
        if s + 2.609438 >= 5.0 * z:
            break
        t = math.log(z)
        if s > t:
            break
        if r + alpha * math.log(alpha / (b + w)) >= t:
            break
    return b / (b + w) if aa != a else w / (b + w)


def rand_beta_exact(nonce, static_id, words, a, b, lo=None, hi=None, n=None):
    """hl.rand_beta parity: jdistlib Beta.random per row, rejection-resampled
    into [lo, hi] when bounds are given (RandomSeededFunctions rand_beta)."""
    s, ft = pmac_hash(nonce, static_id, words, n)
    nrows = s.shape[0]
    av = np.broadcast_to(np.asarray(a, dtype=np.float64), (nrows,))
    bv = np.broadcast_to(np.asarray(b, dtype=np.float64), (nrows,))
    out = np.empty(nrows, dtype=np.float64)
    for i in range(nrows):
        eng = ScalarEngine(s[i], ft)
        val = rbeta_engine(eng, float(av[i]), float(bv[i]))
        if lo is not None or hi is not None:
            lo_ = 0.0 if lo is None else lo
            hi_ = 1.0 if hi is None else hi
            while val < lo_ or val > hi_:
                val = rbeta_engine(eng, float(av[i]), float(bv[i]))
        out[i] = val
    return out


def rand_cat_exact(nonce, static_id, words, weights, n=None):
    """hl.rand_cat parity: u = _rand_unif(block) * sum(weights), then linear
    scan (RandomSeededFunctions rand_cat). `weights` is (n, k)."""
    s, ft = pmac_hash(nonce, static_id, words, n)
    block = threefry_encrypt(s, (ft, U64(0)))
    u = map4_unif(block)
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim == 1:
        w = np.broadcast_to(w[None, :], (s.shape[0], w.shape[0]))
    total = w.sum(axis=1)
    r = u * total
    # the scode scans by SUBTRACTION (r > w[i] -> r -= w[i]; i++), which is
    # not bit-identical to a cumulative-sum comparison — replicate it
    k = w.shape[1]
    nrows = w.shape[0]
    idx = np.zeros(nrows, dtype=np.int64)
    rows = np.arange(nrows)
    for _ in range(k):
        w_i = w[rows, np.minimum(idx, k - 1)]
        cond = (r > w_i) & (idx < k)
        if not cond.any():
            break
        r = np.where(cond, r - w_i, r)
        idx = np.where(cond, idx + 1, idx)
    return idx.astype(np.int32)


def _scalar_next_gaussian(eng: 'ScalarEngine') -> float:
    """Engine nextGaussian: polar method with one buffered deviate
    (Random.scala:520-538)."""
    import math
    if getattr(eng, '_buffered_gaussian', None) is not None:
        g = eng._buffered_gaussian
        eng._buffered_gaussian = None
        return g
    while True:
        v1 = 2 * eng.next_double() - 1
        v2 = 2 * eng.next_double() - 1
        s = v1 * v1 + v2 * v2
        if not (s >= 1 or s == 0):
            break
    multiplier = math.sqrt(-2 * math.log(s) / s)
    eng._buffered_gaussian = v2 * multiplier
    return v1 * multiplier


ScalarEngine.next_gaussian = _scalar_next_gaussian

# R sexp.c q table: q[k] = sum_{i=1..k+1} (ln 2)^i / i!
import math as _math
_SEXP_Q = []
_acc = 0.0
_term = 1.0
for _i in range(1, 17):
    _term *= _math.log(2.0) / _i
    _acc += _term
    _SEXP_Q.append(_acc)
del _acc, _term, _i


def _scalar_next_exp(eng: 'ScalarEngine') -> float:
    """R exp_rand (sexp.c): the Ahrens-Dieter exponential sampler the
    engine's rgamma consumes."""
    a = 0.0
    u = eng.next_double()
    while u <= 0.0 or u >= 1.0:
        u = eng.next_double()
    while True:
        u += u
        if u > 1.0:
            break
        a += _SEXP_Q[0]
    u -= 1.0
    if u <= _SEXP_Q[0]:
        return a + u
    i = 0
    ustar = eng.next_double()
    umin = ustar
    while True:
        ustar = eng.next_double()
        if umin > ustar:
            umin = ustar
        i += 1
        if not (u > _SEXP_Q[i]):
            break
    return a + umin * _SEXP_Q[0]


ScalarEngine.next_exp = _scalar_next_exp


def rgamma_engine(eng: 'ScalarEngine', a: float, scale: float) -> float:
    """Gamma variate via R rgamma.c (GS for a<1, GD for a>=1; jdistlib
    Gamma.random) consuming the engine's draw stream."""
    import math
    sqrt32 = 5.656854
    exp_m1 = 0.36787944117144232
    q1, q2, q3, q4 = 0.04166669, 0.02083148, 0.00801191, 0.00144121
    q5, q6, q7 = -7.388e-5, 2.4511e-4, 2.424e-4
    a1_, a2_, a3_, a4_ = 0.3333333, -0.250003, 0.2000062, -0.1662921
    a5_, a6_, a7_ = 0.1423657, -0.1367177, 0.1233795

    if math.isnan(a) or math.isnan(scale):
        return float('nan')
    if a <= 0.0 or scale <= 0.0:
        if scale == 0.0 or a == 0.0:
            return 0.0
        return float('nan')
    if not (math.isfinite(a) and math.isfinite(scale)):
        return float('inf')

    if a < 1.0:  # GS
        e = 1.0 + exp_m1 * a
        while True:
            p = e * eng.next_double()
            if p >= 1.0:
                x = -math.log((e - p) / a)
                if eng.next_exp() >= (1.0 - a) * math.log(x):
                    break
            else:
                x = math.exp(math.log(p) / a)
                if eng.next_exp() >= x:
                    break
        return scale * x

    # GD
    s2 = a - 0.5
    s = math.sqrt(s2)
    d = sqrt32 - s * 12
    t = eng.norm_rand()
    x = s + 0.5 * t
    ret_val = x * x
    if t >= 0:
        return scale * ret_val
    u = eng.next_double()
    if d * u <= t * t * t:
        return scale * ret_val
    r = 1.0 / a
    q0 = ((((((q7 * r + q6) * r + q5) * r + q4) * r + q3) * r + q2) * r + q1) * r
    if a <= 3.686:
        b = 0.463 + s + 0.178 * s2
        si = 1.235
        c = 0.195 / s - 0.079 + 0.16 * s
    elif a <= 13.022:
        b = 1.654 + 0.0076 * s2
        si = 1.68 / s + 0.275
        c = 0.062 / s + 0.024
    else:
        b = 1.77
        si = 0.75
        c = 0.1515 / s
    if x > 0:
        v = t / (s + s)
        if abs(v) <= 0.25:
            q = q0 + 0.5 * t * t * ((((((a7_ * v + a6_) * v + a5_) * v + a4_)
                                      * v + a3_) * v + a2_) * v + a1_) * v
        else:
            q = q0 - s * t + 0.25 * t * t + (s2 + s2) * math.log(1.0 + v)
        if math.log(1.0 - u) <= q:
            return scale * ret_val
    while True:
        e = eng.next_exp()
        u = eng.next_double()
        u = u + u - 1
        t = (b - si * e) if u < 0 else (b + si * e)
        if t >= -0.71874483771719:
            v = t / (s + s)
            if abs(v) <= 0.25:
                q = q0 + 0.5 * t * t * ((((((a7_ * v + a6_) * v + a5_) * v
                                           + a4_) * v + a3_) * v + a2_) * v
                                        + a1_) * v
            else:
                q = q0 - s * t + 0.25 * t * t + (s2 + s2) * math.log(1.0 + v)
            if q > 0:
                w = math.expm1(q) if q <= 0.5 else math.exp(q) - 1
                if c * abs(u) <= w * math.exp(e - 0.5 * t * t):
                    break
    x = s + 0.5 * t
    return scale * x * x


def rand_norm_exact(nonce, static_id, words, mean, sd, n=None) -> np.ndarray:
    s, ft = pmac_hash(nonce, static_id, words, n)
    nrows = s.shape[0]
    m = np.broadcast_to(np.asarray(mean, dtype=np.float64), (nrows,))
    sdv = np.broadcast_to(np.asarray(sd, dtype=np.float64), (nrows,))
    out = np.empty(nrows)
    for i in range(nrows):
        out[i] = m[i] + sdv[i] * ScalarEngine(s[i], ft).next_gaussian()
    return out


def rand_gamma_exact(nonce, static_id, words, shape, scale, n=None) -> np.ndarray:
    s, ft = pmac_hash(nonce, static_id, words, n)
    nrows = s.shape[0]
    av = np.broadcast_to(np.asarray(shape, dtype=np.float64), (nrows,))
    sc = np.broadcast_to(np.asarray(scale, dtype=np.float64), (nrows,))
    out = np.empty(nrows)
    for i in range(nrows):
        out[i] = rgamma_engine(ScalarEngine(s[i], ft), float(av[i]), float(sc[i]))
    return out


def _scalar_norm_rand(eng: 'ScalarEngine') -> float:
    """R norm_rand (snorm.c INVERSION): two uniforms fused to 2^27-grid
    precision, then the AS 241 quantile — what jdistlib's distribution
    samplers (rgamma et al.) consume internally."""
    from ..stats.rmath import qnorm
    BIG = 134217728  # 2^27
    u1 = eng.next_double()
    u1 = int(BIG * u1) + eng.next_double()
    return qnorm(u1 / BIG, 0.0, 1.0, True, False)


ScalarEngine.norm_rand = _scalar_norm_rand


_POIS_FACT = [1., 1., 2., 6., 24., 120., 720., 5040., 40320., 362880.]
_POIS_A = (-0.5, 0.3333333, -0.2500068, 0.2000118, -0.1661269, 0.1421878,
           -0.1384794, 0.1250060)


def rpois_engine(eng: 'ScalarEngine', mu: float) -> float:
    """Poisson variate via R rpois.c (Ahrens-Dieter PD for mu>=10, inversion
    table for mu<10; jdistlib Poisson.random) on the engine stream."""
    import math
    if not math.isfinite(mu) or mu < 0:
        return float('nan')
    if mu <= 0.0:
        return 0.0

    if mu < 10:  # Case B: inversion with on-the-fly cumulative table
        p0 = math.exp(-mu)
        while True:
            u = eng.next_double()
            if u <= p0:
                return 0.0
            p = p0
            q = p0
            for k in range(1, 36):
                p *= mu / k
                q += p
                if u <= q:
                    return float(k)
            # u beyond pp[35]: redraw (R continues the repeat loop)

    # Case A: mu >= 10
    s = math.sqrt(mu)
    d = 6.0 * mu * mu
    big_l = math.floor(mu - 1.1484)
    omega = (1.0 / math.sqrt(2 * math.pi)) / s
    b1 = (1.0 / 24.0) / mu
    b2 = 0.3 * b1 * b1
    c3 = (1.0 / 7.0) * b1 * b2
    c2 = b2 - 15.0 * c3
    c1 = b1 - 6.0 * b2 + 45.0 * c3
    c0 = 1.0 - b1 + 3.0 * b2 - 15.0 * c3
    c = 0.1069 / mu

    a0, a1, a2, a3, a4, a5, a6, a7 = _POIS_A

    def step_f(pois, fk, difmuk):
        if pois < 10:
            px = -mu
            py = mu ** pois / _POIS_FACT[int(pois)]
        else:
            delta = (1.0 / 12.0) / fk
            delta = delta * (1.0 - 4.8 * delta * delta)
            v = difmuk / fk
            if abs(v) <= 0.25:
                px = fk * v * v * (((((((a7 * v + a6) * v + a5) * v + a4)
                                     * v + a3) * v + a2) * v + a1) * v + a0) \
                    - delta
            else:
                px = fk * math.log(1.0 + v) - difmuk - delta
            py = (1.0 / math.sqrt(2 * math.pi)) / math.sqrt(fk)
        x = (0.5 - difmuk) / fk
        xx = x * x
        fx = -0.5 * xx
        fy = omega * (((c3 * xx + c2) * xx + c1) * xx + c0)
        return px, py, fx, fy

    g = mu + s * eng.norm_rand()
    if g >= 0.0:
        pois = math.floor(g)
        if pois >= big_l:            # Step I: immediate acceptance
            return pois
        fk = pois
        difmuk = mu - fk
        u = eng.next_double()
        if d * u >= difmuk * difmuk * difmuk:   # Step S: squeeze
            return pois
        px, py, fx, fy = step_f(pois, fk, difmuk)
        # Step Q: quotient acceptance
        if fy - u * fy <= py * math.exp(px - fx):
            return pois

    while True:  # Step E: double-exponential sample
        E = eng.next_exp()
        u = 2.0 * eng.next_double() - 1.0
        t = 1.8 + math.copysign(E, u)
        if t > -0.6744:
            pois = math.floor(mu + s * t)
            fk = pois
            difmuk = mu - fk
            px, py, fx, fy = step_f(pois, fk, difmuk)
            # Step H: hat acceptance
            if c * abs(u) <= py * math.exp(px + E) - fy * math.exp(fx + E):
                continue
            return pois


def rand_pois_exact(nonce, static_id, words, lamb, n=None) -> np.ndarray:
    s, ft = pmac_hash(nonce, static_id, words, n)
    nrows = s.shape[0]
    lv = np.broadcast_to(np.asarray(lamb, dtype=np.float64), (nrows,))
    out = np.empty(nrows)
    for i in range(nrows):
        out[i] = rpois_engine(ScalarEngine(s[i], ft), float(lv[i]))
    return out


# ln(i!) for i = 0..7 (R nmath rhyper.c afc table)
_AFC_TABLE = (
    0.0, 0.0,
    0.69314718055994530941723212145817,
    1.79175946922805500081247735838070,
    3.17805383034794561964694160129705,
    4.78749174278204599424770093452324,
    6.57925121201010099506017829290394,
    8.52516136106541430016553103634712,
)
_M_LN_SQRT_2PI = 0.918938533204672741780329736406


def _afc(i: int) -> float:
    """ln(i!): table for i<=7, Stirling otherwise (rhyper.c afc)."""
    import math
    if i <= 7:
        return _AFC_TABLE[i]
    di = float(i)
    di2 = di * di
    return ((di + 0.5) * math.log(di) - di + _M_LN_SQRT_2PI
            + (0.0833333333333333 - 0.00277777777777778 / di2) / di)


def rhyper_engine(eng: 'ScalarEngine', nn1in: float, nn2in: float,
                  kkin: float) -> float:
    """Hypergeometric variate: R nmath rhyper.c (HIN inverse transformation
    for narrow distributions, Kachitvichyanukul-Schmeiser H2PE otherwise),
    consuming the engine's nextDouble stream -- the algorithm jdistlib
    HyperGeometric.random runs for the reference's rand_hyper
    (RandomSeededFunctions.scala:334, Random.scala:449)."""
    import math
    nn1 = int(round(nn1in))
    nn2 = int(round(nn2in))
    kk = int(round(kkin))
    if nn1 < 0 or nn2 < 0 or kk < 0 or kk > nn1 + nn2:
        return float('nan')

    tn = float(nn1 + nn2)
    if nn1 <= nn2:
        n1, n2 = nn1, nn2
    else:
        n1, n2 = nn2, nn1
    k = int(tn) - kk if kk + kk >= tn else kk
    m = int((k + 1.0) * (n1 + 1.0) / (tn + 2.0))
    minjx = max(0, k - n2)
    maxjx = min(n1, k)

    if minjx == maxjx:
        ix = maxjx
    elif m - minjx < 10:
        # II: (scaled) inverse transformation, restart on overrun
        scale = 1e25
        con = 57.5646273248511421  # 25 * ln(10)
        if k - n2 >= 0:
            lw = _afc(n1) + _afc(k) - _afc(k - n2) - _afc(n1 + n2)
        else:
            lw = _afc(n2) + _afc(n1 + n2 - k) - _afc(n2 - k) - _afc(n1 + n2)
        w = math.exp(lw + con)
        while True:
            p = w
            ix = minjx
            u = eng.next_double() * scale
            restart = False
            while u > p:
                u -= p
                p *= float(n1 - ix) * (k - ix)
                ix += 1
                p = p / ix / (n2 - k + ix)
                if ix > maxjx:
                    restart = True
                    break
            if not restart:
                break
    else:
        # III: H2PE rectangle + exponential tails
        s = math.sqrt((tn - k) * k * n1 * n2 / (tn - 1) / tn / tn)
        d = float(int(1.5 * s)) + 0.5
        xl = m - d + 0.5
        xr = m + d + 0.5
        a = _afc(m) + _afc(n1 - m) + _afc(k - m) + _afc(n2 - k + m)
        kl = math.exp(a - _afc(int(xl)) - _afc(int(n1 - xl))
                      - _afc(int(k - xl)) - _afc(int(n2 - k + xl)))
        kr = math.exp(a - _afc(int(xr - 1)) - _afc(int(n1 - xr + 1))
                      - _afc(int(k - xr + 1)) - _afc(int(n2 - k + xr - 1)))
        lamdl = -math.log(xl * (n2 - k + xl) / (n1 - xl + 1) / (k - xl + 1))
        lamdr = -math.log((n1 - xr + 1) * (k - xr + 1) / xr / (n2 - k + xr))
        p1 = d + d
        p2 = p1 + kl / lamdl
        p3 = p2 + kr / lamdr
        while True:
            u = eng.next_double() * p3
            v = eng.next_double()
            if u < p1:                      # rectangular region
                ix = int(xl + u)
            elif u <= p2:                   # left tail
                ix = int(xl + math.log(v) / lamdl)
                if ix < minjx:
                    continue
                v = v * (u - p1) * lamdl
            else:                           # right tail
                ix = int(xr - math.log(v) / lamdr)
                if ix > maxjx:
                    continue
                v = v * (u - p2) * lamdr
            # acceptance test: explicit f evaluation (the m>=100 && ix>50
            # squeeze in rhyper.c is an evaluation shortcut for the same
            # v <= f comparison; the explicit recurrence is its exact form)
            f = 1.0
            if m < ix:
                for i in range(m + 1, ix + 1):
                    f = f * (n1 - i + 1) * (k - i + 1) / (n2 - k + i) / i
            elif m > ix:
                for i in range(ix + 1, m + 1):
                    f = f * i * (n2 - k + i) / (n1 - i + 1) / (k - i + 1)
            if v <= f:
                break

    # map back to the caller's (nn1, kk) orientation
    if kk + kk >= tn:
        ix = kk - nn2 + ix if nn1 > nn2 else nn1 - ix
    elif nn1 > nn2:
        ix = kk - ix
    return float(ix)


def rand_hyper_exact(nonce, static_id, words, popsize, ngood, nsample,
                     n=None) -> np.ndarray:
    """hl.rand_hyper parity: rhyper(ngood, popsize-ngood, nsample) per row
    (RandomSeededFunctions.scala rand_hyper)."""
    s, ft = pmac_hash(nonce, static_id, words, n)
    nrows = s.shape[0]
    pv = np.broadcast_to(np.asarray(popsize, dtype=np.int64), (nrows,))
    gv = np.broadcast_to(np.asarray(ngood, dtype=np.int64), (nrows,))
    kv = np.broadcast_to(np.asarray(nsample, dtype=np.int64), (nrows,))
    out = np.empty(nrows, dtype=np.int32)
    for i in range(nrows):
        eng = ScalarEngine(s[i], ft)
        out[i] = int(rhyper_engine(eng, float(gv[i]),
                                   float(pv[i] - gv[i]), float(kv[i])))
    return out


def rand_multi_hyper_exact(nonce, static_id, words, colors, nsample,
                           n=None) -> np.ndarray:
    """hl.rand_multi_hyper parity: sequential conditional rhyper draws off
    one engine stream (RandomSeededFunctions.scala rand_multi_hyper:366-402).
    `colors` is (n, k) or (k,); returns (n, k) int32."""
    s, ft = pmac_hash(nonce, static_id, words, n)
    nrows = s.shape[0]
    cols = np.asarray(colors, dtype=np.int64)
    if cols.ndim == 1:
        cols = np.broadcast_to(cols, (nrows,) + cols.shape)
    kcol = cols.shape[1]
    nv = np.broadcast_to(np.asarray(nsample, dtype=np.int64), (nrows,))
    out = np.empty((nrows, kcol), dtype=np.int32)
    for i in range(nrows):
        eng = ScalarEngine(s[i], ft)
        remaining = int(cols[i].sum())
        to_sample = int(nv[i])
        for j in range(kcol):
            nj = int(cols[i, j])
            remaining -= nj
            drawn = int(rhyper_engine(eng, float(nj), float(remaining),
                                      float(to_sample)))
            to_sample -= drawn
            out[i, j] = drawn
    return out
