"""Batched Needleman-Wunsch in plain JAX (the conquer-step DP, off the hot path).

The reference closes every "normal pair" (avg ~20 bp gapped fragment) with
a full O(mn) 3-matrix float DP (reference: src/nw_alignment.cpp:18-80).
This module runs that DP for a whole batch of fragment pairs at once as an
antidiagonal wavefront: the state is six (N, lm+1) float32 vectors (r, t, s
on the two previous diagonals), row i of diagonal d holding cell (i, d-i),
and one `lax.scan` step computes a whole diagonal for every pair.

Exactness: the DP is float32 add/max only, in the reference order
(nw_alignment.cpp:47-60).  The only products are by 0/1 (substitution
score) and by exact halves (gap ramps), so every value is exactly
representable and no compiler reordering or fusion (FMA included) can
change a bit.  Scores, the equality ties the backtrace keys on, and hence
the alignments are bit-identical to the host numpy DP
(pipeline/conquer.py::nw_alignment) on any backend, with no tolerance.

The device emits backtrace decision bits (bit0: s==r, bit1: s==t at each
cell); the sequential, data-dependent backtrace walk stays on the host
(nw_backtrace), mirroring the reference's tie-break order (r first, then
t — nw_alignment.cpp:61-68).

Production conquer is the native AVX2 NW (native/kart_post.cpp); this batch
form is reached only by `-backend python` with KART_BATCH_NW=1.  Fragments
longer than the largest tile (the 8-mer repartition keeps Illumina
fragments ~20 bp; PacBio recursion keeps them <= ~300) run the host DP.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_PENALTY = np.float32(-65536)
OPEN_GAP = np.float32(-1)
EXTEND_GAP = np.float32(-0.5)
NEW_GAP = np.float32(-1.5)

_TILES = (16, 32, 64, 128)  # beyond the largest: host DP


@functools.partial(jax.jit, static_argnames=("lm",))
def nw_batch_planes(c1, c2, *, lm: int):
    """DP decision bitplanes for a batch of fragment pairs.

    c1, c2: (N, lm) int8 codes padded with 4 / 5 (pads differ so padding
    never matches).  Returns (N, lm+1, lm+1) uint8, bit0 = (s==r) and
    bit1 = (s==t) at cell (i, j)."""
    n = c1.shape[0]
    lp = lm + 1
    iv = jnp.arange(lp, dtype=jnp.int32)[None, :]  # vector row = i
    # c1g[:, i] = s1[i-1] (row 0 is padding).  s2 reversed and padded by lm
    # on the left: the window starting at 2lm-d puts s2[d-i-1] at row i.
    c1g = jnp.pad(c1.astype(jnp.int32), ((0, 0), (1, 0)), constant_values=4)
    c2r = jnp.pad(c2.astype(jnp.int32)[:, ::-1], ((0, 0), (lm, lp)),
                  constant_values=5)
    maxp = jnp.full((n, lp), MAX_PENALTY, jnp.float32)

    def gap(d):
        return OPEN_GAP + d.astype(jnp.float32) * EXTEND_GAP

    def boundary(d, R, T, S):
        """Boundary cells (0, d) and (d, 0) (nw_alignment.cpp:36-46)."""
        top = (iv == 0) & (d <= lm)
        left = iv == d
        g = gap(d)
        R = jnp.where(top, g, jnp.where(left, MAX_PENALTY, R))
        T = jnp.where(left, g, jnp.where(top, MAX_PENALTY, T))
        S = jnp.where(top | left, g, S)
        return R, T, S

    def bits(R, T, S):
        return ((S == R).astype(jnp.uint8) | ((S == T).astype(jnp.uint8) << 1))

    def shift_down(x):  # row i reads row i-1 (cell (i-1, .) of that diagonal)
        return jnp.concatenate([maxp[:, :1], x[:, :-1]], axis=1)

    # d = 0: the origin, r = t = s = 0; d = 1: boundary cells only
    R0 = T0 = S0 = jnp.where(iv == 0, jnp.float32(0), maxp)
    R1, T1, S1 = boundary(jnp.int32(1), maxp, maxp, maxp)

    def step(carry, d):
        Spp, Rp, Tp, Sp = carry
        c2g = jax.lax.dynamic_slice_in_dim(c2r, 2 * lm - d, lp, axis=1)
        sub = jnp.where(c1g == c2g, jnp.float32(1.5), jnp.float32(-1.5))
        rv = jnp.maximum(Rp + EXTEND_GAP, Sp + NEW_GAP)  # from (i, j-1)
        tv = jnp.maximum(shift_down(Tp) + EXTEND_GAP, shift_down(Sp) + NEW_GAP)
        sv = jnp.maximum(jnp.maximum(shift_down(Spp) + sub, rv), tv)
        interior = (iv >= 1) & (iv <= d - 1) & (d - iv <= lm)
        R, T, S = boundary(
            d,
            jnp.where(interior, rv, maxp),
            jnp.where(interior, tv, maxp),
            jnp.where(interior, sv, maxp),
        )
        return (Sp, R, T, S), bits(R, T, S)

    _, eq = jax.lax.scan(
        step, (S0, R1, T1, S1), jnp.arange(2, 2 * lm + 1, dtype=jnp.int32)
    )
    diag = jnp.concatenate(
        [bits(R0, T0, S0)[None], bits(R1, T1, S1)[None], eq], axis=0
    )  # (2lm+1, N, lp): diag[d, :, i] = cell (i, d-i)
    ii = np.arange(lp)[:, None]
    jj = np.arange(lp)[None, :]
    return jnp.transpose(diag[ii + jj, :, ii], (2, 0, 1))


def nw_backtrace(eq: np.ndarray, s1: bytes, s2: bytes) -> tuple[bytes, bytes]:
    """Reconstruct the gapped strings from one pair's decision bitplane,
    walking exactly like the reference backtrace (r first, then t;
    boundary cells: j>0&i==0 -> r-move, i>0&j==0 -> t-move, which the
    boundary init guarantees via s==r / s==t there)."""
    i, j = len(s1), len(s2)
    out1 = bytearray()
    out2 = bytearray()
    while i > 0 or j > 0:
        b = eq[i, j]
        if b & 1:
            out1.append(0x2D)
            out2.append(s2[j - 1])
            j -= 1
        elif b & 2:
            out1.append(s1[i - 1])
            out2.append(0x2D)
            i -= 1
        else:
            out1.append(s1[i - 1])
            out2.append(s2[j - 1])
            i -= 1
            j -= 1
    out1.reverse()
    out2.reverse()
    return bytes(out1), bytes(out2)


# device-vs-host fragment coverage (observability; reset at will)
nw_stats = {"device": 0, "host": 0}


def encode_tile(pairs, lm):
    """(s1, s2) ASCII pairs -> (N, lm) int8 code arrays padded 4 / 5.
    The reference compares nst_nt4 codes (N == N matches), so real
    ambiguous bases share code 6 and only padding differs per side."""
    from ..index.format import NT4_TABLE

    n = len(pairs)
    c1 = np.full((n, lm), 4, np.int8)
    c2 = np.full((n, lm), 5, np.int8)
    for k, (a, b) in enumerate(pairs):
        c1[k, : len(a)] = NT4_TABLE[np.frombuffer(a, np.uint8)]
        c2[k, : len(b)] = NT4_TABLE[np.frombuffer(b, np.uint8)]
        c1[k, : len(a)][c1[k, : len(a)] == 4] = 6
        c2[k, : len(b)][c2[k, : len(b)] == 4] = 6
    return c1, c2


def nw_align_batch(pairs: list[tuple[bytes, bytes]]):
    """Align a batch of (s1, s2) ASCII fragment pairs on the device;
    returns gapped (a1, a2) string pairs, each bit-identical to
    pipeline.conquer.nw_alignment(s1, s2).

    Pairs are grouped into size-bucketed tile batches; pairs exceeding the
    largest tile (possible only on degenerate PacBio fragments — callers
    keep NW inputs small via 8-mer repartition / recursion) run the host
    DP."""
    if not pairs:
        return []
    buckets: dict[int, list[int]] = {}
    host_idx = []
    for k, (a, b) in enumerate(pairs):
        m = max(len(a), len(b))
        t = next((t for t in _TILES if t >= m), None)
        if t is None:
            host_idx.append(k)
        else:
            buckets.setdefault(t, []).append(k)
    out: list = [None] * len(pairs)
    for t, idxs in sorted(buckets.items()):
        tile = [pairs[k] for k in idxs]
        c1, c2 = encode_tile(tile, t)
        eq = np.asarray(nw_batch_planes(jnp.asarray(c1), jnp.asarray(c2), lm=t))
        for k, e, (a, b) in zip(idxs, eq, tile):
            out[k] = nw_backtrace(e, a, b)
        nw_stats["device"] += len(idxs)
    from ..pipeline.conquer import nw_alignment

    for k in host_idx:
        out[k] = nw_alignment(*pairs[k])
    nw_stats["host"] += len(host_idx)
    return out
