"""Batched FM-index search kernels (JAX).

These are the two hot loops of the aligner (reference: src/bwt_search.cpp):

1. `seed_scan` — the FastMode seeding pass (IdentifySeedPairs_FastMode +
   BWT_Search, reference src/AlignmentCandidates.cpp:49-80 and
   src/bwt_search.cpp:140-184) recast as a uniform left-to-right scan:
   every read in the batch advances one read position per step, maintaining
   an (x0, x1, x2) interval triple; maximal exact extensions end exactly when
   the interval empties or an ambiguous base is hit, at which point a seed
   block (start, length, SA-interval start, freq) is recorded and the scan
   re-seeds at the next position.  This turns the reference's per-read
   while-loop into a fixed-trip-count batched loop with no data-dependent
   control flow, which XLA compiles to one loop of batched steps.

2. `sa_walk` — batched suffix-array resolution (bwt_sa, src/bwt_search.cpp:
   128-138): up to sa_intv-1 masked inverse-Psi steps per occurrence.

Arithmetic is int32 (genomes < 2^31 text bases); the occurrence counting
uses the same 2-bit popcount trick as the reference's __occ_aux, vectorized
over lanes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

OCC_THR = 50


@jax.tree_util.register_pytree_node_class
@dataclass
class FMIndexArrays:
    """Device-resident FM-index (de-interleaved Occ/BWT layout).

    occ_cp and bwt_words are stored FLAT (1D), de-interleaved from the
    reference's .bwt payload: a lookup gathers exactly the 4 Occ counts /
    8 BWT words of its block, by flat index, with no padding."""

    occ_cp: jax.Array  # (n_blocks * 4,) i32/i64 — checkpoint counts, row-major
    bwt_words: jax.Array  # (n_blocks * 8,) uint32 — BWT words, row-major
    sa_samples: jax.Array  # (n_sa,) i32/i64
    L2: jax.Array  # (5,) i32/i64
    primary: jax.Array  # () i32/i64
    seq_len: jax.Array  # () i32/i64
    sa_full: jax.Array | None = None  # (seq_len+1,) — fast-path SA

    def tree_flatten(self):
        return (
            (
                self.occ_cp,
                self.bwt_words,
                self.sa_samples,
                self.L2,
                self.primary,
                self.seq_len,
                self.sa_full,
            ),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_genome_index(cls, gidx, sharding=None, with_full_sa=None):
        """with_full_sa=None (auto): ship the full SA only for sub-2^31
        indexes — at human scale it is 17+ GB and stays host-side (the
        mapper expands occurrences with a host gather)."""
        d = gidx.device_arrays
        if with_full_sa is None:
            with_full_sa = gidx.seq_len < 2**31
        put = (lambda x: jax.device_put(x, sharding)) if sharding is not None else jnp.asarray
        return cls(
            occ_cp=put(np.ascontiguousarray(d["occ_cp"]).reshape(-1)),
            bwt_words=put(np.ascontiguousarray(d["bwt_words"]).reshape(-1)),
            sa_samples=put(d["sa_samples"]),
            L2=put(d["L2"]),
            primary=put(d["primary"]),
            seq_len=put(d["seq_len"]),
            sa_full=put(gidx.sa_full.astype(gidx.index_dtype, copy=False))
            if with_full_sa
            else None,
        )


# numpy scalar: a module-level jnp constant would initialize the device
# backend at import time (and hang if the accelerator is unreachable)
_M55 = np.uint32(0x55555555)


def _count4_word(w):
    """Per-char occurrence counts in one 32-bit BWT word (16 bases).
    Vectorized equivalent of the reference cnt_table trick (__occ_aux4).
    w: uint32 array of any shape -> (4,) + shape int32 counts."""
    nw = ~w
    m0 = (nw >> 1) & nw & _M55
    m1 = (nw >> 1) & w & _M55
    m2 = (w >> 1) & nw & _M55
    m3 = (w >> 1) & w & _M55
    stacked = jnp.stack([m0, m1, m2, m3])
    return jax.lax.population_count(stacked).astype(jnp.int32)


def occ4_from(words, base, kk):
    """Block-level bwt_occ4: counts of each code in bwt[0..kk] given the
    block's 8 BWT words and its Occ checkpoint `base` (4,).  Shared by the
    replicated path (occ4) and the mesh-sharded path
    (parallel.sharded_index), which source words/base differently.
    Dtype-polymorphic: kk/base may be int32 or (human-scale) int64; the
    intra-block counts are always int32 and promote into base's type."""
    jk = ((kk & 0x7F) >> 4).astype(jnp.int32)
    counts = _count4_word(words)  # (4, 8)
    jj = jnp.arange(8, dtype=jnp.int32)
    full = jnp.sum(jnp.where(jj < jk, counts, 0), axis=1)  # (4,)
    shift = ((~kk & 0xF) << 1).astype(jnp.uint32)
    mask = ~((jnp.uint32(1) << shift) - jnp.uint32(1))
    partial = _count4_word(words[jk] & mask)  # (4,)
    cnt = base + (full + partial).astype(base.dtype)
    return cnt - (jnp.array([1, 0, 0, 0], jnp.int32) * (~kk & 0xF).astype(jnp.int32)).astype(base.dtype)


def occ4(fm: FMIndexArrays, k):
    """bwt_occ4(k): counts of each code in bwt[0..k] (k int32 scalar,
    0 <= k <= seq_len; the reference's k==-1 case cannot arise in our call
    sites because x1 >= 1 always)."""
    kk = k - (k >= fm.primary).astype(k.dtype)
    blk = kk >> 7
    words = fm.bwt_words[blk * 8 + jnp.arange(8)]
    base = fm.occ_cp[blk * 4 + jnp.arange(4)]
    return occ4_from(words, base, kk)


def bwt_char(fm: FMIndexArrays, x):
    """bwt_B0: 2-bit code at primary-adjusted row x."""
    w = fm.bwt_words[(x >> 7) * 8 + ((x & 0x7F) >> 4)]
    return ((w >> (((~x & 0xF) << 1).astype(jnp.uint32))) & jnp.uint32(3)).astype(jnp.int32)


def inv_psi(fm: FMIndexArrays, k):
    """bwt_invPsi(k) for one row (index dtype: int32 or int64)."""
    x = k - (k > fm.primary).astype(k.dtype)
    c = bwt_char(fm, x)
    occ_kc = occ4(fm, k)[c]
    # occ(k==seq_len, c) special case collapses to the same value (full
    # counts), so no branch is needed; k==primary maps to row 0.
    nk = fm.L2[c] + occ_kc
    return jnp.where(k == fm.primary, 0, nk)


# ---------------------------------------------------------------------------
# Seeding scan (FastMode)
# ---------------------------------------------------------------------------


def seed_scan_impl(occ4_pair, L2, primary, reads, rlens, min_seed_len, *, max_seeds, l_max):
    """Core batched FastMode seeding scan, parameterized over the PAIRED
    occ4 lookup (`occ4_pair: ((B,), (B,)) rows -> ((B,4), (B,4)) counts`) so
    the same scan runs against a replicated FM-index (seed_scan) or an
    index sharded across a mesh axis (parallel.sharded_index) — the paired
    form lets the sharded path answer both lookups of a scan step with ONE
    psum instead of two.

    Row/interval state (x0, x1, x2, k0) carries L2's dtype — int32 for
    sub-2^31 indexes, int64 at human scale."""
    B = reads.shape[0]
    idt = L2.dtype
    # extra trailing column of ambiguous codes so the last extension of every
    # read terminates (and emits its seed) inside the fixed-trip loop
    reads = jnp.pad(reads, ((0, 0), (0, 1)), constant_values=4)

    def step(p, state):
        active, start, x0, x1, x2, n_seeds, rpos, slen, k0f, freqf = state
        p = jnp.asarray(p).astype(jnp.int32)  # fori index is int64 under x64
        c = jax.lax.dynamic_index_in_dim(reads, p, axis=1, keepdims=False)  # (B,)
        amb = c > 3
        c_safe = jnp.minimum(c, 3)

        # --- extension attempt for active lanes (uniform compute) ---
        tk, tl = occ4_pair(x1 - 1, x1 - 1 + x2)  # (B, 4) each
        ok_x1 = L2[None, :4] + 1 + tk
        ok_x2 = tl - tk
        s3 = x0 + ((x1 <= primary) & (x1 + x2 - 1 >= primary)).astype(x0.dtype)
        s2 = s3 + ok_x2[:, 3]
        s1 = s2 + ok_x2[:, 2]
        s0 = s1 + ok_x2[:, 1]
        ok_x0 = jnp.stack([s0, s1, s2, s3], axis=1)  # (B, 4)

        i = 3 - c_safe
        bidx = jnp.arange(B)
        nx0 = ok_x0[bidx, i]
        nx1 = ok_x1[bidx, i]
        nx2 = ok_x2[bidx, i]

        ext_fail = amb | (nx2 == 0)

        # --- seed emission: active extension ended at p ---
        emit = active & ext_fail
        length = p - start
        record = emit & (length >= min_seed_len) & (x2 <= OCC_THR)
        slot = jnp.where(record, n_seeds, max_seeds)  # out-of-bounds -> drop
        rpos = rpos.at[bidx, slot].set(start, mode="drop")
        slen = slen.at[bidx, slot].set(length, mode="drop")
        k0f = k0f.at[bidx, slot].set(x0, mode="drop")
        freqf = freqf.at[bidx, slot].set(x2, mode="drop")
        n_seeds = n_seeds + record.astype(jnp.int32)

        # --- state transition ---
        # inactive & !amb & p < rlen - min_seed_len: start a new extension
        can_start = (~active) & (~amb) & (p < rlens - min_seed_len)
        init_x0 = L2[c_safe] + idt.type(1)
        init_x1 = L2[3 - c_safe] + idt.type(1)
        init_x2 = L2[c_safe + 1] - L2[c_safe]

        cont = active & ~ext_fail
        new_active = cont | can_start
        new_start = jnp.where(can_start, p, start)
        new_x0 = jnp.where(cont, nx0, jnp.where(can_start, init_x0, x0))
        new_x1 = jnp.where(cont, nx1, jnp.where(can_start, init_x1, x1))
        new_x2 = jnp.where(cont, nx2, jnp.where(can_start, init_x2, x2))
        return (new_active, new_start, new_x0, new_x1, new_x2, n_seeds, rpos, slen, k0f, freqf)

    # derive the zero-init carry from the inputs so it inherits their
    # device-varying type under shard_map (a literal zeros() carry is
    # "unvarying" and rejected by the manual-axes check)
    z = rlens * 0
    zi = z.astype(idt)
    zb = rlens < 0
    zs = jnp.zeros((B, max_seeds), jnp.int32) + z[:, None]
    zsi = jnp.zeros((B, max_seeds), idt) + zi[:, None]
    # reads are padded with an extra column of 4s so the final active
    # extension terminates and emits inside the loop
    state = (zb, z, zi, zi, zi, z, zs, zs, zsi, zsi)
    state = jax.lax.fori_loop(0, l_max + 1, step, state)
    _, _, _, _, _, n_seeds, rpos, slen, k0f, freqf = state
    # single packed output: one device->host transfer (see kmer_seed.py).
    # int32 throughout at small scale; promoted to the index dtype when the
    # row starts (k0) need 64 bits.
    return jnp.concatenate(
        [n_seeds[:, None].astype(idt), rpos.astype(idt), slen.astype(idt), k0f, freqf],
        axis=1,
    )


def _occ4_pair_replicated(fm: FMIndexArrays):
    occ4_b = jax.vmap(lambda k: occ4(fm, k))

    def pair(ka, kb):
        return occ4_b(ka), occ4_b(kb)

    return pair


@functools.partial(jax.jit, static_argnames=("max_seeds", "l_max"))
def seed_scan(fm: FMIndexArrays, reads, rlens, min_seed_len, *, max_seeds, l_max):
    return seed_scan_impl(
        _occ4_pair_replicated(fm), fm.L2, fm.primary, reads.astype(jnp.int32),
        rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max,
    )


def unpack_seed_scan(packed, max_seeds: int) -> dict:
    """Split seed_scan's packed (B, 1 + 4*max_seeds) result into fields."""
    return dict(
        n_seeds=packed[:, 0],
        rpos=packed[:, 1 : 1 + max_seeds],
        slen=packed[:, 1 + max_seeds : 1 + 2 * max_seeds],
        k0=packed[:, 1 + 2 * max_seeds : 1 + 3 * max_seeds],
        freq=packed[:, 1 + 3 * max_seeds : 1 + 4 * max_seeds],
    )


# ---------------------------------------------------------------------------
# Seeding scan (SensitiveMode, PacBio)
# ---------------------------------------------------------------------------


def sensitive_scan_impl(
    occ4_pair, L2, primary, reads, rlens, min_seed_len, *, max_seeds, l_max
):
    """Batched SensitiveMode seeding (IdentifySeedPairs_SensitiveMode,
    reference src/AlignmentCandidates.cpp:132-169 + BWT_Search
    src/bwt_search.cpp:140-184).

    Differences from the FastMode scan that force a while_loop with a
    per-lane position (instead of a fixed one-position-per-trip scan):

      * extensions are windowed to 30 bp (stop_pos == min(pos+30, rlen));
      * a successful seed restarts the next extension AT the end position
        (pos += len), not one past it;
      * a failed seed (len < MinSeedLength, or freq > OCC_Thr) advances by
        MinSeedLength from the seed START — which can be BEHIND the
        current scan position when a long extension was too frequent.

    Every loop trip consumes one base of some extension per lane; lanes
    exit when pos >= rlen - MinSeedLength with no active extension.  Trip
    count is bounded by ~(31/MinSeedLength)*rlen; the loop exits as soon
    as every lane is done.

    Returns the same packed (B, 1 + 4*max_seeds) layout as seed_scan:
    [n_seeds | rpos | len | k0 | freq] with seeds in emission (rpos) order.
    """
    B = reads.shape[0]
    idt = L2.dtype
    reads = jnp.pad(reads, ((0, 0), (0, 1)), constant_values=4)
    L = reads.shape[1] - 1
    end_pos = rlens - min_seed_len
    bidx = jnp.arange(B)

    z = rlens * 0
    zi = z.astype(idt)
    zb = rlens < 0
    zs = jnp.zeros((B, max_seeds), jnp.int32) + z[:, None]
    zsi = jnp.zeros((B, max_seeds), idt) + zi[:, None]
    # state: p, active, s, x0, x1, x2, n_seeds, rpos, slen, k0f, freqf
    state = (z, zb, z, zi, zi + idt.type(1), zi, z, zs, zs, zsi, zsi, jnp.int32(0))
    max_trips = 31 * (l_max // jnp.maximum(min_seed_len, 1) + 2)

    def cond(st):
        p, active, *_, it = st
        done = (~active) & (p >= end_pos)
        return (~jnp.all(done)) & (it < max_trips)

    def body(st):
        p, active, s, x0, x1, x2, n_seeds, rpos, slen, k0f, freqf, it = st
        done = (~active) & (p >= end_pos)
        pc = jnp.minimum(p, L)
        c = jnp.take_along_axis(reads, pc[:, None], axis=1)[:, 0]
        amb = c > 3
        c_safe = jnp.minimum(c, 3)
        stop = jnp.minimum(s + 30, rlens)

        # --- uniform extension attempt (clamped rows for inactive lanes) ---
        x1s = jnp.maximum(x1, idt.type(1))
        tk, tl = occ4_pair(x1s - 1, x1s - 1 + jnp.maximum(x2, idt.type(0)))
        ok_x1 = L2[None, :4] + 1 + tk
        ok_x2 = tl - tk
        s3 = x0 + ((x1 <= primary) & (x1 + x2 - 1 >= primary)).astype(x0.dtype)
        s2_ = s3 + ok_x2[:, 3]
        s1_ = s2_ + ok_x2[:, 2]
        s0_ = s1_ + ok_x2[:, 1]
        ok_x0 = jnp.stack([s0_, s1_, s2_, s3], axis=1)
        i = 3 - c_safe
        nx0 = ok_x0[bidx, i]
        nx1 = ok_x1[bidx, i]
        nx2 = ok_x2[bidx, i]

        at_stop = p >= stop
        ext_fail = active & (amb | at_stop | (nx2 == 0))

        # --- seed emission on extension end ---
        length = p - s
        freq_ok = (length >= min_seed_len) & (x2 <= OCC_THR)
        record = ext_fail & freq_ok & (n_seeds < max_seeds)
        slot = jnp.where(record, n_seeds, max_seeds)
        rpos = rpos.at[bidx, slot].set(s, mode="drop")
        slen = slen.at[bidx, slot].set(length, mode="drop")
        k0f = k0f.at[bidx, slot].set(x0, mode="drop")
        freqf = freqf.at[bidx, slot].set(x2, mode="drop")
        n_seeds = n_seeds + record.astype(jnp.int32)

        # --- next state ---
        cont = active & ~ext_fail
        # restart position: at p on success, s+min_seed on failure
        fail_restart = ext_fail & ~freq_ok
        # lanes idle at p (never-started or just ended successfully) may
        # start a new extension at p this trip
        startable = (~done) & (~cont) & (~fail_restart) & (~amb) & (p < end_pos)
        init_x0 = L2[c_safe] + idt.type(1)
        init_x1 = L2[3 - c_safe] + idt.type(1)
        init_x2 = L2[c_safe + 1] - L2[c_safe]

        new_active = cont | startable
        new_s = jnp.where(startable, p, s)
        new_x0 = jnp.where(cont, nx0, jnp.where(startable, init_x0, x0))
        new_x1 = jnp.where(cont, nx1, jnp.where(startable, init_x1, x1))
        new_x2 = jnp.where(cont, nx2, jnp.where(startable, init_x2, x2))
        # position: advance by 1 while extending/starting/skipping an
        # ambiguous or spent base; jump to s+min_seed on failed seed
        new_p = jnp.where(
            fail_restart, s + min_seed_len, jnp.where(done, p, p + 1)
        )
        new_active = new_active & ~fail_restart
        return (
            new_p, new_active, new_s, new_x0, new_x1, new_x2,
            n_seeds, rpos, slen, k0f, freqf, it + 1,
        )

    state = jax.lax.while_loop(cond, body, state)
    _, _, _, _, _, _, n_seeds, rpos, slen, k0f, freqf, _ = state
    return jnp.concatenate(
        [n_seeds[:, None].astype(idt), rpos.astype(idt), slen.astype(idt), k0f, freqf],
        axis=1,
    )


@functools.partial(jax.jit, static_argnames=("max_seeds", "l_max"))
def sensitive_scan(fm: FMIndexArrays, reads, rlens, min_seed_len, *, max_seeds, l_max):
    return sensitive_scan_impl(
        _occ4_pair_replicated(fm), fm.L2, fm.primary, reads.astype(jnp.int32),
        rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max,
    )


# ---------------------------------------------------------------------------
# Suffix-array resolution
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("max_steps",))
def sa_walk(fm: FMIndexArrays, ks, sa_intv_log2=np.int32(5), *, max_steps=4096):
    """Batched bwt_sa: resolve rows ks (N,) int32 to text positions via
    masked inverse-Psi steps until every lane reaches a sampled row.

    The sampled SA marks rows whose *row index* is a multiple of sa_intv
    (reference: bwt_cal_sa, src/BWT_Index/bwt.c:101-123), so a walk takes
    geometric(1/32) many steps — expected 32, unbounded worst case.  We use
    a while_loop that exits when all lanes are done (or at max_steps; lanes
    still unresolved then are reported via the returned done mask and must
    be finished by the caller's fallback path)."""
    mask = (jnp.int32(1) << sa_intv_log2) - 1

    def cond(state):
        k, add, it = state
        return (it < max_steps) & jnp.any((k & mask) != 0)

    def body(state):
        k, add, it = state
        at_sample = (k & mask) == 0
        nk = jax.vmap(lambda kk: inv_psi(fm, kk))(k)
        k = jnp.where(at_sample, k, nk)
        add = add + (~at_sample).astype(jnp.int32)
        return (k, add, it + 1)

    add0 = jnp.zeros_like(ks)
    k, add, _ = jax.lax.while_loop(cond, body, (ks, add0, jnp.int32(0)))
    done = (k & mask) == 0
    return add + fm.sa_samples[k >> sa_intv_log2], done


@jax.jit
def sa_resolve_full(sa_full, ks):
    """Full-SA resolution: one gather. `sa_full[(k)] == bwt_sa(k)` for every
    row k >= 1 (for genomes whose full int32 SA fits in device memory this
    removes the invPsi walk entirely — the fast path)."""
    return sa_full[ks]
