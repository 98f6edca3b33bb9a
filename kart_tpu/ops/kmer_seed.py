"""Direct-lookup seeding engine (device fast path for genomes up to ~600 Mbp).

Replaces the per-base FM backward-search scan with a wavefront of direct
13-mer table lookups + vectorized maximal-extension compares, producing
seeds identical to IdentifySeedPairs_FastMode (reference:
src/AlignmentCandidates.cpp:49-80 + src/bwt_search.cpp:140-184):

- All occurrences of a read's 13-mer form a contiguous suffix-array
  interval [lo, hi).  A direct-address table (4^13 int32 entries, built
  from the full SA at index load) yields it in ONE gather — replacing
  13 occ4 interval updates.
- The FM maximal exact extension from p equals the maximum LCP between
  read[p:] and the genome at the interval's hit positions; the hits
  achieving it are a contiguous sub-interval in SA row order, so the
  engine emits the same (rpos, len, sa_row_start, freq) records as the
  batched FM stepper, resolved by the same full-SA gather.
- Restarts whose 13-mer has no genuine occurrence advance by the exact
  FM extension length (< 13), recovered from per-length presence
  bitmaps (k = 12..4) and the first-ambiguous-base offset.
- Lanes whose 13-mer interval exceeds hit_cap (deep repeats) or that
  exhaust the round budget are flagged `ok=False` and must be re-seeded
  with the exact FM stepper — the engine is a fast path, never an
  approximation.

Why this shape suits an accelerator: the FM scan issues ~2L dependent
random 48-byte gathers per read (latency-bound); this engine does ~4
gathers per restart plus wide word gathers and elementwise compares, all
independent across lanes.  Its speed on the H100 is not measured yet.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

K = 13
OCC_THR = 50
BITMAP_KS = (12, 11, 10, 9, 8, 7, 6, 5, 4)


@dataclass
class KmerSeedTables:
    """Direct-lookup engine tables, host (numpy) resident; device copies are
    created lazily for the device engine.  The same arrays back the native C++
    engine via ctypes (kart_post.cpp seed_read_direct)."""

    table_lo_np: np.ndarray  # (4^13 + 1,) int32: SA-interval start per kmer
    text_np: np.ndarray  # (2L + seg_pad,) int8 codes, padded with 5
    sa_full_np: np.ndarray  # (2L + 1,) int32
    bitmaps_np: tuple  # per k in BITMAP_KS: (4^k/32,) uint32 presence words
    sub_tbl_np: np.ndarray  # (4^13,) uint16: bit k set iff the k-prefix occurs
    seq_len: int
    max_mult: int  # max 13-mer multiplicity (for hit_cap sizing)
    all_short_present: bool  # every 4-mer occurs (sub-13 lengths exact)

    def _dev(self, name, value):
        key = "_d_" + name
        if not hasattr(self, key):
            object.__setattr__(self, key, jnp.asarray(value))
        return getattr(self, key)

    @property
    def table_lo(self):
        return self._dev("table_lo", self.table_lo_np)

    @property
    def text(self):
        return self._dev("text", self.text_np)

    @property
    def sa_full(self):
        return self._dev("sa_full", self.sa_full_np)

    @property
    def bitmaps(self):
        key = "_d_bitmaps"
        if not hasattr(self, key):
            object.__setattr__(self, key, tuple(jnp.asarray(b) for b in self.bitmaps_np))
        return getattr(self, key)

    @property
    def sub_tbl(self):
        return self._dev("sub_tbl", self.sub_tbl_np)

    @property
    def text_words(self):
        """2-bit packed text, 16 bases per uint32 (ambiguous/pad bases pack
        as 0 — extension results are capped at seq_len-loc and the read's
        first-ambiguous offset, so their packed value never leaks into an
        LCP).  This is the gather target of the word-packed extension
        compare: 13 uint32 loads per hit instead of a 160-byte window."""
        key = "_d_text_words"
        if not hasattr(self, key):
            c = np.where(self.text_np > 3, 0, self.text_np).astype(np.uint32)
            nw = -(-len(c) // 16)
            pad = np.zeros(nw * 16, np.uint32)
            pad[: len(c)] = c
            shifts = (2 * np.arange(16)).astype(np.uint32)
            w = (pad.reshape(nw, 16) << shifts).sum(axis=1, dtype=np.uint32)
            object.__setattr__(self, key, jnp.asarray(w))
        return getattr(self, key)


def build_tables(gidx, seg_pad: int = 1024, cache: bool = True) -> KmerSeedTables:
    """Build (or load from the `.kmt` index sidecar) the direct-lookup
    seeding tables.  The sidecar makes table construction a one-time cost
    per index — required for large genomes, where the numpy build takes
    tens of seconds."""
    prefix = getattr(gidx.raw, "prefix", None)
    kmt = prefix + ".kmt" if prefix else None
    if cache and kmt:
        try:
            import os

            if os.path.exists(kmt):
                z = np.load(kmt)
                return KmerSeedTables(
                    table_lo_np=z["table_lo"],
                    text_np=z["text"],
                    sa_full_np=gidx.sa_full.astype(np.int32),
                    bitmaps_np=tuple(z[f"bm{i}"] for i in range(len(BITMAP_KS))),
                    sub_tbl_np=z["subtbl"],  # KeyError on pre-r4 sidecars -> rebuild
                    seq_len=int(z["seq_len"][0]),
                    max_mult=int(z["seq_len"][1]),
                    all_short_present=bool(z["seq_len"][2]),
                )
        except Exception:
            pass
    tb = _build_tables_fresh(gidx, seg_pad)
    if cache and kmt:
        try:
            arrs = dict(
                table_lo=tb.table_lo_np,
                text=tb.text_np,
                subtbl=tb.sub_tbl_np,
                seq_len=np.array(
                    [tb.seq_len, tb.max_mult, int(tb.all_short_present)], np.int64
                ),
            )
            for i, bm in enumerate(tb.bitmaps_np):
                arrs[f"bm{i}"] = bm
            tmp = kmt + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **arrs)
            import os

            os.replace(tmp, kmt)
        except Exception:
            pass
    return tb


def _build_tables_fresh(gidx, seg_pad: int = 1024) -> KmerSeedTables:
    codes = gidx.ref_codes.astype(np.int64)  # (2L,), values 0..3
    seq_len = int(gidx.seq_len)
    sa = gidx.sa_full.astype(np.int64)  # (2L+1,)

    # packed 13-mer at every text position (0-padded past the end; bogus
    # short-suffix entries are filtered at query time by loc > 2L-13)
    padded = np.concatenate([codes, np.zeros(K, np.int64)])
    kmer = np.zeros(seq_len + 1, dtype=np.int64)
    for i in range(K):
        kmer = (kmer << 2) | padded[i : i + seq_len + 1]

    ids_sorted = kmer[sa]  # non-decreasing over SA rows (0-padding sorts low)
    counts = np.bincount(ids_sorted, minlength=4**K)
    table_lo = np.zeros(4**K + 1, dtype=np.int32)
    np.cumsum(counts, out=table_lo[1:])
    max_mult = int(counts.max())

    bitmaps = []
    all_short = True
    # per-13-mer presence bitmask: bit k set iff the id's k-prefix occurs in
    # the genome — ONE gather at scan time replaces the 9 per-round bitmap
    # tests
    sub_tbl = np.zeros(4**K, dtype=np.uint16)
    all_ids13 = np.arange(4**K, dtype=np.int64)
    for k in BITMAP_KS:
        kk = np.zeros(seq_len - k + 1, dtype=np.int64)
        for i in range(k):
            kk = (kk << 2) | codes[i : i + seq_len - k + 1]
        present = np.zeros(4**k, dtype=bool)
        present[kk] = True
        if k == BITMAP_KS[-1]:
            all_short = bool(present.all())
        sub_tbl |= present[all_ids13 >> (2 * (K - k))].astype(np.uint16) << k
        words = np.packbits(present.reshape(-1, 32), axis=1, bitorder="little")
        bitmaps.append(np.frombuffer(words.tobytes(), dtype="<u4").copy())

    text_padded = np.concatenate(
        [gidx.ref_codes.astype(np.int8), np.full(seg_pad, 5, np.int8)]
    )
    return KmerSeedTables(
        table_lo_np=table_lo,
        text_np=text_padded,
        sa_full_np=gidx.sa_full.astype(np.int32),
        bitmaps_np=tuple(bitmaps),
        sub_tbl_np=sub_tbl,
        seq_len=seq_len,
        max_mult=max_mult,
        all_short_present=all_short,
    )


def _bitmap_test(bitmap, idx):
    w = bitmap[idx >> 5]
    return ((w >> (idx & 31).astype(jnp.uint32)) & jnp.uint32(1)) != 0



def _distance_tables(amb, l_max):
    """For each (read, p): distance to first ambiguous base at/after p and
    distance to first NON-ambiguous base at/after p (both capped l_max).

    One reverse cummin per table: next_amb[p] = min_{q>=p, amb[q]} q, so the
    distance is next_amb - p (capped) — replacing the former 2*l_max-step
    unrolled scan (~320 sequential (B,) kernels per slab)."""
    pos = jnp.arange(l_max, dtype=jnp.int32)[None, :]
    big = jnp.int32(2 * l_max + 1)
    next_amb = jax.lax.cummin(jnp.where(amb, pos, big), axis=1, reverse=True)
    next_base = jax.lax.cummin(jnp.where(~amb, pos, big), axis=1, reverse=True)
    d_amb = jnp.minimum(next_amb - pos, l_max)
    d_base = jnp.minimum(next_base - pos, l_max)
    return d_amb, d_base


import os as _os

# rows per device slab: the per-round text-window gather + compare
# intermediates grow with the rows scanned at once and are the scan's
# device-memory high-water mark.  Larger fused dispatch groups are
# lax.map'ed over slabs of this size inside ONE jit call, which bounds
# peak memory independently of the group size.
_SLAB_ROWS = 4096

# compacted-extension hit budget per lane (average): lanes whose interval
# hits overrun the round's H = _HIT_BUDGET * B compact rows are flagged
# ok=False and re-seeded exactly by the FM stepper (same contract as
# hit_cap interval overflow).  Per-round work grows with H; overflow costs
# only a re-seed dispatch, never correctness.
_HIT_BUDGET = int(_os.environ.get("KART_HIT_BUDGET", "2"))


@functools.partial(
    jax.jit,
    static_argnames=("max_seeds", "l_max", "hit_cap", "rounds", "seq_len",
                     "sensitive"),
)
def kmer_seed_scan(
    table_lo,
    text_words,
    sa_full,
    sub_tbl,
    reads,
    rlens,
    min_seed_len,
    *,
    max_seeds,
    l_max,
    hit_cap,
    rounds,
    seq_len,
    sensitive=False,
):
    """Direct-lookup seeding (slab-batched over _SLAB_ROWS).

    reads: (B, l_max) int32 codes padded with 4.  Returns the seed_scan
    schema — (B, max_seeds) rpos/slen/k0/freq + (B,) n_seeds — where k0
    is the SA row of the first maximal occurrence, plus (B,) bool `ok`.

    sensitive=False: FastMode (IdentifySeedPairs_FastMode) — restart at
    p + len + 1, exact sub-13 restart lengths from the presence table.
    sensitive=True: SensitiveMode (IdentifySeedPairs_SensitiveMode,
    reference src/AlignmentCandidates.cpp:132-169) — extensions window-
    capped at 30 bp (so the funnel needs only W=4 words per hit even for
    32 kb PacBio reads), restart at p + len on success and p + MinSeed on
    failure; no sub-13 table (failures always advance MinSeed)."""
    B = reads.shape[0]
    if B <= _SLAB_ROWS:
        return _kmer_seed_scan_slab(
            table_lo, text_words, sa_full, sub_tbl, reads, rlens, min_seed_len,
            max_seeds=max_seeds, l_max=l_max, hit_cap=hit_cap, rounds=rounds,
            seq_len=seq_len, sensitive=sensitive,
        )
    ns = -(-B // _SLAB_ROWS)
    pad = ns * _SLAB_ROWS - B
    if pad:
        reads = jnp.pad(reads, ((0, pad), (0, 0)), constant_values=4)
        rlens = jnp.pad(rlens, (0, pad))
    out = jax.lax.map(
        lambda rr: _kmer_seed_scan_slab(
            table_lo, text_words, sa_full, sub_tbl, rr[0], rr[1], min_seed_len,
            max_seeds=max_seeds, l_max=l_max, hit_cap=hit_cap, rounds=rounds,
            seq_len=seq_len, sensitive=sensitive,
        ),
        (
            reads.reshape(ns, _SLAB_ROWS, l_max),
            rlens.reshape(ns, _SLAB_ROWS),
        ),
    )
    return out.reshape(ns * _SLAB_ROWS, -1)[:B]


def _kmer_seed_scan_slab(
    table_lo,
    text_words,
    sa_full,
    sub_tbl,
    reads,
    rlens,
    min_seed_len,
    *,
    max_seeds,
    l_max,
    hit_cap,
    rounds,
    seq_len,
    sensitive=False,
):
    """One slab of the direct-lookup scan (see kmer_seed_scan)."""
    B = reads.shape[0]
    bidx = jnp.arange(B)
    last_valid = seq_len - K
    reads = reads.astype(jnp.int32)  # int8 transfers welcome

    # rolling 13-mer ids per read position (26 bits, int32 suffices);
    # window-amb flag
    r64 = reads.astype(jnp.int32)
    padded = jnp.pad(r64, ((0, 0), (0, K)), constant_values=4)
    kmer = jnp.zeros((B, l_max), jnp.int32)
    amb_in_win = jnp.zeros((B, l_max), bool)
    for i in range(K):
        col = jax.lax.dynamic_slice_in_dim(padded, i, l_max, axis=1)
        kmer = (kmer << 2) | jnp.where(col > 3, 0, col)
        amb_in_win = amb_in_win | (col > 3)
    kmer = kmer.astype(jnp.int32)

    amb = reads > 3
    amb_off, nonamb_off = _distance_tables(amb, l_max)
    # packed per-position tables: one (B,) take-along gather per round
    # instead of two (the round loop is a chain of dependent gathers).
    # Offsets clamp to 15/16-bit
    # fields; a clamped skip still deactivates the lane (p + 32767 passes
    # every end_pos for l_max <= 32768)
    assert l_max <= (32768 if sensitive else 512), "packed field widths"
    postab1 = kmer | (amb_in_win.astype(jnp.int32) << 26)
    postab2 = (jnp.minimum(nonamb_off, 0x7FFF) << 16) | jnp.minimum(
        amb_off, 0xFFFF
    )
    # sensitive windows cap extensions at 30 bp; damb field width + the
    # rs emission packing shift follow the mode
    WIN = 30 if sensitive else l_max
    DB = 5 if sensitive else 10  # damb-1 bits (<= 30 / <= 512)
    RS = 5 if sensitive else 15  # slen bits in the rs pack (<=30 / <=512)

    # ---- word-packed extension compare setup ------------------------------
    # Hits from all lanes are compacted into a fixed budget of H rows per
    # round (lanes whose hits overrun the budget are flagged for exact FM
    # re-seeding, like interval overflow).  Each hit's extension is an XOR +
    # count-trailing-zeros over 12 funnel-aligned 2-bit-packed uint32 words
    # (192 bases) instead of a 160-byte window compare: ~400x fewer gathered
    # elements than a dense (B, hit_cap, l_max) layout.
    # SensitiveMode rounds keep EVERY lane active (one restart per round),
    # so the per-round hit total runs ~2x FastMode's; keep its budget >= 4
    H = max(_HIT_BUDGET, 4) * B if sensitive else _HIT_BUDGET * B
    # gathered words per window, derived from l_max so the funnel compare
    # covers the FULL possible extension: W-1 aligned words = (W-1)*16
    # bases >= l_max (ADVICE r3: a fixed W=13 saturated the LCP at 192
    # bases, silently truncating exact matches on reads longer than that)
    # sensitive extensions are <= WIN=30 bases, so W-1=3 aligned words
    # cover them even on 32 kb reads; FastMode needs the full read span
    # (ADVICE r3: a fixed short W silently truncated long exact matches)
    W = 4 if sensitive else (l_max + 15) // 16 + 2
    shifts16 = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    nwr = (l_max + 15) // 16 + W + 1
    rc = jnp.where(amb, 0, reads).astype(jnp.uint32)
    rc = jnp.pad(rc, ((0, 0), (0, nwr * 16 - l_max)))
    rwords = (rc.reshape(B, nwr, 16) << shifts16).sum(axis=2, dtype=jnp.uint32)
    jhit = jnp.arange(H, dtype=jnp.int32)
    seq_len_i = jnp.int32(seq_len)

    # idx field width in the packed segment-max words (covers H up to 2^20)
    IDXB = 20
    IDXM = (1 << IDXB) - 1

    def round_body(_, state):
        p, n_seeds, rs_b, k0_b, freq_b, overflow = state
        # bulk-skip ambiguous restart positions (EncodeSeq[pos]>3 -> pos++)
        p_idx = jnp.minimum(p, l_max - 1)
        p = jnp.minimum(p + (postab2[bidx, p_idx] >> 16), jnp.int32(l_max))
        p_idx = jnp.minimum(p, l_max - 1)

        active = p < (rlens - min_seed_len)

        pk1 = postab1[bidx, p_idx]  # amb_in_win<<26 | kmer
        aoff = postab2[bidx, p_idx] & 0xFFFF  # amb_off at the NEW p
        km = pk1 & ((1 << 26) - 1)
        valid13 = active & ((pk1 >> 26) == 0)
        lo = jnp.where(valid13, table_lo[km], 0)
        hi = jnp.where(valid13, table_lo[km + 1], 0)
        cnt = hi - lo
        over = active & (cnt > hit_cap)
        overflow = overflow | over
        cnt = jnp.where(over, 0, cnt)

        # compact (lane, hit) pairs into H rows via cumsum + repeat
        cum = jnp.cumsum(cnt)
        start = cum - cnt
        fits = cum <= H
        overflow = overflow | (active & (cnt > 0) & ~fits)
        total = cum[-1]
        # jnp.repeat(total_repeat_length=H) truncates at the budget and
        # pads the tail with the last lane id; validity masking below makes
        # both exact (one cumsum+scatter instead of a log(B) searchsorted
        # per hit)
        hit_lane = jnp.repeat(
            jnp.arange(B, dtype=jnp.int32), cnt, total_repeat_length=H
        )
        lane_c = jnp.minimum(hit_lane, B - 1)

        # ---- packed per-lane pickup: int32 hit-gathers carry all
        # per-lane state (start/damb/fits, lo-start), so lane fields ride
        # shared words instead of one H-sized gather each.
        # read-side extension cap damb = min(first-amb-distance, remaining
        # read, window): >= 1 at any valid restart, stored -1 in DB bits
        damb1 = jnp.clip(
            jnp.minimum(jnp.minimum(aoff, rlens - p), WIN) - 1,
            0, (1 << DB) - 1,
        )
        g1 = (
            (jnp.minimum(start, (1 << (29 - DB)) - 1) << (DB + 2))
            | (damb1 << 2)
            | fits.astype(jnp.int32)
        )
        a = lo - start  # rows = lo + hit_idx = a + jhit; a >= -H
        g1h = g1[lane_c]
        a_h = a[lane_c]
        start_h = g1h >> (DB + 2)
        damb_h = ((g1h >> 2) & ((1 << DB) - 1)) + 1
        fits_h = (g1h & 1) == 1

        valid_hit = (jhit < total) & fits_h
        hit_idx = jhit - start_h
        rows = a_h + jhit
        locs = sa_full[jnp.where(valid_hit, rows, 0)]
        genuine = valid_hit & (locs <= last_valid)
        # bogus short-suffix rows inside the interval (<= K rows globally):
        # the maximizer block below is located by CONTIGUITY in SA order,
        # which an interleaved bogus row would break — such lanes are
        # flagged for the exact FM re-seed instead (same contract as
        # hit_cap/budget overflow; outputs stay byte-identical)
        bogus = valid_hit & (locs > last_valid)
        locs_s = jnp.where(genuine, locs, 0).astype(jnp.int32)

        # funnel-aligned text window: W packed words -> W-1 aligned words,
        # laid out TRANSPOSED as (W, H) so the large hit dimension is the
        # minor (contiguous) one and every word row is one wide gather
        twT = text_words[
            jnp.arange(W, dtype=jnp.int32)[:, None] + (locs_s >> 4)[None, :]
        ]  # (W, H)
        shT = ((locs_s & 15) * 2).astype(jnp.uint32)[None, :]
        t_alT = (twT[:-1] >> shT) | jnp.where(
            shT > 0, twT[1:] << (jnp.uint32(32) - shT), jnp.uint32(0)
        )

        # per-lane aligned read window at its restart p: (W-1, B) built in
        # lane space, then one (W-1, H) column gather per hit
        wr = jnp.arange(W, dtype=jnp.int32)
        rwT = rwords[bidx[None, :], (p_idx >> 4)[None, :] + wr[:, None]]
        rshB = ((p_idx & 15) * 2).astype(jnp.uint32)[None, :]
        r_alB = (rwT[:-1] >> rshB) | jnp.where(
            rshB > 0, rwT[1:] << (jnp.uint32(32) - rshB), jnp.uint32(0)
        )
        r_alT = r_alB[:, lane_c]

        # LCP via leading-zero-word count + count-trailing-zeros of the
        # first nonzero word, all as (W-1, H) elementwise + short-axis
        # reductions (no per-hit gather of the argmax word)
        xorT = t_alT ^ r_alT  # (W-1, H)
        iszero = (xorT == 0).astype(jnp.uint32)
        prefix_zero = jnp.cumprod(iszero, axis=0)  # 1 while prefix all-zero
        nzw = jnp.sum(prefix_zero, axis=0).astype(jnp.int32)  # leading 0-words
        anym = nzw < (W - 1)
        pz_shift = jnp.concatenate(
            [jnp.ones((1, H), jnp.uint32), prefix_zero[:-1]], axis=0
        )
        first_mask = (pz_shift == 1) & (iszero == 0)
        xw = jnp.sum(jnp.where(first_mask, xorT, 0), axis=0)  # (H,)
        ctz = jax.lax.population_count((xw & (jnp.uint32(0) - xw)) - jnp.uint32(1))
        lcp_h = jnp.where(anym, nzw * 16 + (ctz >> 1).astype(jnp.int32), (W - 1) * 16)
        # read-side cap: first ambiguous base AND remaining read length —
        # amb_off alone misses the read end when rlen == l_max (no pad-4
        # sentinel), and the zero-padded read words would match 'A' text
        lcp_h = jnp.minimum(lcp_h, jnp.minimum(damb_h, seq_len_i - locs_s))
        lcp_h = jnp.minimum(lcp_h, jnp.int32(l_max))
        lcp_h = jnp.where(genuine, lcp_h, -1)

        # ---- per-lane reduction: TWO independent packed segment_maxes
        # (replacing max + sum + min + a best[lane] re-gather).  The
        # maximal-LCP rows form a CONTIGUOUS sub-interval in SA order
        # (sorted suffixes: rows between two maximizers share the same
        # query prefix), so best/freq/first_off all come from the packed
        # (lcp+1)<<IDXB | idx extrema; a bogus row poisons contiguity and
        # rides A2's bit 30 into the overflow flag instead.
        seg = jnp.where(valid_hit, hit_lane, B)
        idx_c = jnp.clip(hit_idx, 0, IDXM)
        lc1 = (lcp_h + 1) << IDXB
        pack_first = jnp.where(genuine, lc1 | (IDXM - idx_c), -1)
        pack_last = jnp.where(
            genuine, lc1 | idx_c, jnp.where(bogus, jnp.int32(1) << 30, -1)
        )
        A1 = jax.ops.segment_max(pack_first, seg, num_segments=B + 1)[:B]
        A2 = jax.ops.segment_max(pack_last, seg, num_segments=B + 1)[:B]
        has_bogus = A2 >= (jnp.int32(1) << 30)
        overflow = overflow | has_bogus
        best = jnp.maximum(jax.lax.shift_right_arithmetic(A1, IDXB) - 1, -1)
        first_off = IDXM - (A1 & IDXM)
        freq = jnp.where(best >= 0, (A2 & IDXM) - first_off + 1, 0)
        has13 = valid13 & (best >= K)
        row0 = lo + jnp.where(freq > 0, first_off, 0)

        if sensitive:
            # SensitiveMode: failures advance MinSeedLength from the seed
            # START regardless of the partial extension, so no sub-13
            # length is needed (AlignmentCandidates.cpp:160-166)
            length = jnp.where(has13, best, 0)
        else:
            # sub-13 exact restart length: ONE bitmask-table gather (bit k
            # of sub_tbl[km] set iff the k-prefix occurs in the genome) +
            # highest set bit allowed by the first-ambiguous offset —
            # replaces the 9 per-round bitmap gathers
            msk = sub_tbl[km].astype(jnp.int32)
            allow = msk & ((jnp.int32(1) << (jnp.minimum(aoff, K) + 1)) - 1)
            sub_len = jnp.where(
                allow > 0, 31 - jax.lax.clz(jnp.maximum(allow, 1)), 0
            )
            length = jnp.where(has13, best, sub_len)

        record = active & has13 & (length >= min_seed_len) & (freq <= OCC_THR) & (freq > 0)
        slot = jnp.where(record, n_seeds, max_seeds)
        # rpos << RS | slen packed: one emission scatter fewer per round
        rs_b = rs_b.at[bidx, slot].set((p << RS) | length, mode="drop")
        k0_b = k0_b.at[bidx, slot].set(row0, mode="drop")
        freq_b = freq_b.at[bidx, slot].set(freq, mode="drop")
        n_seeds = n_seeds + record.astype(jnp.int32)

        if sensitive:
            # success: restart AT the extension end; failure: MinSeed from
            # the seed start (reference sensitive-mode advance rules)
            p = jnp.where(
                active, jnp.where(record, p + length, p + min_seed_len), p
            )
        else:
            p = jnp.where(active, p + length + 1, p)
        return (p, n_seeds, rs_b, k0_b, freq_b, overflow)

    z = rlens * 0
    zb = jnp.zeros((B, max_seeds), jnp.int32) + z[:, None]
    state = (z, z, zb, zb, zb, rlens < 0)
    # early-exit round loop: a slab whose lanes all finished stops paying
    # for the remaining rounds (typical Illumina slabs finish in ~8-12 of
    # the `rounds` worst-case budget)
    _, (p, n_seeds, rs_b, k0_b, freq_b, overflow) = jax.lax.while_loop(
        lambda rs: (rs[0] < rounds)
        & jnp.any(rs[1][0] < (rlens - min_seed_len)),
        lambda rs: (rs[0] + 1, round_body(rs[0], rs[1])),
        (jnp.int32(0), state),
    )
    # a lane is clean iff it ran to completion without interval overflow
    p_idx = jnp.minimum(p, l_max - 1)
    p_final = jnp.minimum(p + (postab2[bidx, p_idx] >> 16), jnp.int32(l_max))
    unfinished = p_final < (rlens - min_seed_len)
    ok = ~(overflow | unfinished)
    # pack into ONE output array: a single device->host transfer
    return jnp.concatenate(
        [
            n_seeds[:, None],
            ok.astype(jnp.int32)[:, None],
            rs_b >> RS,
            rs_b & ((1 << RS) - 1),
            k0_b,
            freq_b,
        ],
        axis=1,
    )


def unpack_seed_result(packed: np.ndarray, max_seeds: int) -> dict:
    """Split the packed (B, 2 + 4*max_seeds) result back into fields."""
    return dict(
        n_seeds=packed[:, 0],
        ok=packed[:, 1] != 0,
        rpos=packed[:, 2 : 2 + max_seeds],
        slen=packed[:, 2 + max_seeds : 2 + 2 * max_seeds],
        k0=packed[:, 2 + 2 * max_seeds : 2 + 3 * max_seeds],
        freq=packed[:, 2 + 3 * max_seeds : 2 + 4 * max_seeds],
    )
