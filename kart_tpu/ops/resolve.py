"""Device-side occurrence expansion + SA resolution + compaction.

The seeding scans (ops/fm_search.py, ops/kmer_seed.py) emit per-read seed
blocks (rpos, len, k0=SA-interval start, freq).  Downstream (the native
divide/conquer pipeline) consumes a FLAT occurrence stream: per-read counts
plus (rpos, len, gpos) per occurrence — the layout the reference builds one
push_back at a time in BWT_Search's resolution loop (reference:
src/bwt_search.cpp:170-181, bwt_sa per occurrence).

Round 3 did this expansion on the HOST with a full-SA gather
(mapper.py `self.sa_full_np[rows]`), which (a) made every production path
require the ~4.5 bytes/base `.saf` full suffix array in host RAM and
(b) forced the device pipeline to ship the whole padded (B, 1+4*max_seeds)
seed matrix to the host (~200 bytes/read).  This module moves the
expansion ON DEVICE, in the
same jit as the scan:

  * occurrences are compacted into a fixed `occ_budget` stream via one
    cumsum + gather (reads whose occurrences overrun the budget are
    flagged with cnt = -1 and re-seeded exactly on the host — same
    contract as the kmer engine's hit_cap overflow);
  * SA rows resolve EITHER by one gather from the device-resident full SA
    (fast path, small genomes) OR by the batched sampled-SA walk
    (`sa_walk_rows`: masked inverse-Psi steps, reference src/BWT_Index/
    bwt.c:101-123 / bwt_search.cpp:128-138) — the memory-frugal production
    mode that needs only `.bwt/.sa`-scale memory on device and none of the
    full SA anywhere;
  * the device->host payload shrinks to ~`9 bytes x occurrences` (one
    packed meta word + one position per occurrence, ~2.2 occ/read on
    Illumina) plus a (B,) count vector.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# The batched sampled-SA walk over arbitrary rows lives in
# fm_search.sa_walk (same (pos, done) / max_steps contract); this module
# re-exports it so resolution callers need only one import (ADVICE r4:
# a near-duplicate walk here had already started to drift).
from .fm_search import sa_walk as sa_walk_rows_jit  # noqa: F401  (jitted)


def expand_resolve(lookup, n_seeds, rpos, slen, k0, freq, ok_in, *, occ_budget):
    """Expand per-read seed blocks into a flat resolved occurrence stream.

    lookup: rows (H,) -> (pos (H,), done (H,) bool) SA resolution
    n_seeds (B,), rpos/slen/k0/freq (B, S); ok_in (B,) bool (scan-level
    validity, e.g. kmer hit_cap overflow).

    Returns (cnts, meta, gpos):
      cnts (B,) int32  — encoded per-read count: tot when the read's
        occurrences are valid in the stream, -tot-1 when the read must be
        host re-seeded (budget overflow / scan overflow / failed walk).
        |decoded tot| always reflects the read's slot span in the stream,
        so stream offsets stay reconstructable on the host.
      meta (occ_budget,) int32 — rpos | slen << 16 per occurrence
      gpos (occ_budget,) index-dtype — resolved text position

    Budget overflow is all-or-nothing per read and, because the stream
    offset is a prefix sum, the overflowing reads are always a SUFFIX of
    the batch: every fitting read's occurrences form a contiguous prefix
    segment at its exact offset.

    Occurrence order: seed emission order x SA-row order within a seed —
    identical to the host expansion (mapper.py round 3) and the reference's
    BWT_Search push order.
    """
    B, S = rpos.shape
    H = occ_budget
    sidx = jnp.arange(S)[None, :] < n_seeds[:, None]
    f = jnp.where(sidx, freq, 0).astype(jnp.int32)  # (B, S)
    tot = f.sum(axis=1)  # (B,)
    f_flat = f.reshape(-1)
    cum = jnp.cumsum(f_flat)
    start = cum - f_flat
    total = cum[-1]
    # per-read budget check: a read fits iff its LAST occurrence lands
    # inside the budget (all-or-nothing per read, so the flat stream stays
    # contiguous per read)
    read_end = jnp.cumsum(tot)
    fits = read_end <= H  # (B,)

    slot = jnp.repeat(
        jnp.arange(B * S, dtype=jnp.int32), f_flat, total_repeat_length=H
    )
    slot_c = jnp.minimum(slot, B * S - 1)
    jh = jnp.arange(H, dtype=jnp.int32)
    lane = slot_c // S
    valid = (jh < total) & fits[lane]
    off = jh - start[slot_c]
    rows = k0.reshape(-1)[slot_c] + off.astype(k0.dtype)
    rows_safe = jnp.where(valid, rows, k0.dtype.type(1))
    gpos, done = lookup(rows_safe)
    # an unresolved walk (max_steps cap) invalidates its whole read
    bad_read = jax.ops.segment_min(
        jnp.where(valid, done.astype(jnp.int32), 1), lane, num_segments=B
    ) == 0
    ok = ok_in & fits & ~bad_read
    # meta carries raw uint32 bits in an int32 lane: slen can legitimately
    # reach 32768 (full-length PacBio exact seed), which sets the sign bit,
    # so consumers must decode with LOGICAL shifts ((meta >> 16) & 0xFFFF)
    # and treat slen-field == 0xFFFF (the -1 fill) as invalid — never
    # meta >= 0 (ADVICE r4).
    meta = rpos.reshape(-1)[slot_c].astype(jnp.int32) | (
        slen.reshape(-1)[slot_c].astype(jnp.int32) << 16
    )
    meta = jnp.where(valid, meta, -1)
    gpos = jnp.where(valid, gpos, gpos.dtype.type(-1))
    cnts = jnp.where(ok, tot, -tot - 1).astype(jnp.int32)
    return cnts, meta, gpos


def decode_resolved_counts(cnts: np.ndarray):
    """Host-side: decode the cnts encoding -> (ok (B,) bool, tot (B,) i32,
    offs (B+1,) i64 stream offsets)."""
    ok = cnts >= 0
    tot = np.where(ok, cnts, -cnts - 1).astype(np.int64)
    offs = np.zeros(len(tot) + 1, dtype=np.int64)
    np.cumsum(tot, out=offs[1:])
    return ok, tot.astype(np.int32), offs
