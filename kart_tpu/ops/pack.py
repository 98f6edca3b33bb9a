"""2-bit packed read transfer for the device-pipelined mode.

Reads for KART_SEED_MODE=device are packed 16 bases per uint32 word on the
host (4x fewer bytes than one int8 code per base) with
ambiguous positions shipped as a sparse (read, pos) list (they are rare;
genome N-runs are randomized at indexing, so only read-side Ns remain), and
unpacked on device inside the SAME jit as the seeding scan — one dispatch,
quarter the bytes.

The jitted entry points (seed_scan_resolved_packed,
sensitive_scan_resolved_packed, kmer_seed_scan_resolved_packed) run the
scans of ops/fm_search.py and ops/kmer_seed.py on the unpacked reads and
resolve their occurrences on device (ops/resolve.py)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .fm_search import FMIndexArrays, seed_scan_impl, sensitive_scan_impl, _occ4_pair_replicated

# sparse-ambiguity capacity buckets: one compile per bucket, padded entries
# scatter out-of-range (dropped)
_AMB_BUCKETS = [0, 256, 4096]


def _amb_bucket(n: int) -> int:
    for b in _AMB_BUCKETS:
        if n <= b:
            return b
    return n


def pack_reads_2bit(reads_i8: np.ndarray):
    """(B, l_max) int8 codes (0..3, >3 ambiguous) -> (words (B, ceil(L/16))
    uint32, amb_r, amb_p int32 sparse ambiguity coordinates, padded to a
    capacity bucket with out-of-range rows).  One-pass native packer when
    the C++ library is available; the numpy pipeline below is the
    fallback."""
    B, L = reads_i8.shape
    nw = -(-L // 16)
    native = _native_pack(reads_i8, B, L, nw)
    if native is not None:
        return native
    amb_mask = reads_i8 > 3
    codes = np.where(amb_mask, 0, reads_i8).astype(np.uint32)
    padded = np.zeros((B, nw * 16), np.uint32)
    padded[:, :L] = codes
    shifts = (2 * np.arange(16)).astype(np.uint32)
    words = (padded.reshape(B, nw, 16) << shifts).sum(axis=2, dtype=np.uint32)
    amb_r, amb_p = np.nonzero(amb_mask)
    cap = _amb_bucket(len(amb_r))
    r = np.full(cap, B, np.int32)  # B = out of range -> dropped scatter
    p = np.zeros(cap, np.int32)
    r[: len(amb_r)] = amb_r
    p[: len(amb_p)] = amb_p
    return words, r, p


def _native_pack(reads_i8, B, L, nw):
    import ctypes

    from ..native.post import load_postlib

    lib = load_postlib()
    if lib is None or not reads_i8.flags.c_contiguous or reads_i8.dtype != np.int8:
        return None
    cap = _AMB_BUCKETS[-1]
    while True:
        words = np.empty((B, nw), np.uint32)
        amb_r = np.full(cap, B, np.int32)
        amb_p = np.zeros(cap, np.int32)
        n = lib.kart_pack_reads_2bit(
            reads_i8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int32(B), ctypes.c_int32(L),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int32(nw),
            amb_r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            amb_p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(cap),
        )
        if n <= cap:
            # shrink to the amb bucket (one compile per bucket)
            b = _amb_bucket(int(n))
            if b < cap:
                amb_r2 = np.full(b, B, np.int32)
                amb_p2 = np.zeros(b, np.int32)
                amb_r2[:n] = amb_r[:n]
                amb_p2[:n] = amb_p[:n]
                return words, amb_r2, amb_p2
            return words, amb_r, amb_p
        cap = 1 << int(np.ceil(np.log2(n)))  # rare: N-dense inputs


def unpack_reads_device(words, amb_r, amb_p, l_max: int):
    """Device-side inverse of pack_reads_2bit -> (B, l_max) int32 codes."""
    j = jnp.arange(l_max, dtype=jnp.int32)
    w = words[:, j >> 4]  # (B, l_max) uint32
    codes = (w >> (2 * (j & 15)).astype(jnp.uint32)) & jnp.uint32(3)
    reads = codes.astype(jnp.int32)
    if amb_r.shape[0]:
        reads = reads.at[amb_r, amb_p].set(4, mode="drop")
    return reads


# ---------------------------------------------------------------------------
# Resolved entry points: scan + on-device occurrence expansion + SA
# resolution + compaction (ops/resolve.py) in ONE jit.  d2h payload is
# ~9 bytes/occurrence instead of ~200 bytes/read.
# ---------------------------------------------------------------------------


def _resolver(fm, mode: str):
    from .fm_search import sa_walk

    if mode == "full":
        return lambda rows: (fm.sa_full[rows], rows == rows)
    return lambda rows: sa_walk(fm, rows)


def _pack_stream(cnts, meta, gpos, pack16=False):
    """Fuse the resolved stream into ONE d2h transfer when dtypes allow:
    one (B+2H,) array instead of three.  int64 (human-scale) gpos stays a
    separate transfer.

    pack16 (static; requires l_max <= 256, even B/H, int32 gpos): cnts
    fit int16 (|cnt| <= max_seeds*OCC_Thr+1 = 601) and meta fits 16 bits
    (rpos < 256, 13 <= slen <= 256 stored as slen-1), so the stream
    shrinks to (B/2 + H/2 + H) words.  Whether this pays on PCIe is not
    measured yet."""
    if gpos.dtype != jnp.int32:
        return (cnts, meta, gpos)
    if not pack16:
        return jnp.concatenate([cnts, meta, gpos])
    c16 = cnts.astype(jnp.uint16).astype(jnp.uint32)
    cw = c16[0::2] | (c16[1::2] << 16)
    m16 = ((meta & 0xFF) | ((((meta >> 16) & 0xFFFF) - 1) << 8)) & 0xFFFF
    m16 = m16.astype(jnp.uint32)
    mw = m16[0::2] | (m16[1::2] << 16)
    return jnp.concatenate(
        [cw.astype(jnp.int32), mw.astype(jnp.int32), gpos]
    )


def unpack_stream(packed, B: int, H: int, pack16: bool = False):
    """Host-side inverse of _pack_stream: always returns the canonical
    (cnts i32 (B,), meta i32 rpos|slen<<16 (H,), gpos (H,)) triple."""
    import numpy as np

    if isinstance(packed, (tuple, list)):
        return tuple(np.asarray(x) for x in packed)
    arr = np.asarray(packed)
    if not pack16:
        return arr[:B], arr[B : B + H], arr[B + H :]
    cw = arr[: B // 2]
    mw = arr[B // 2 : B // 2 + H // 2]
    gpos = arr[B // 2 + H // 2 :]
    cnts = cw.view(np.int16).astype(np.int32)
    m16 = mw.view(np.uint16).astype(np.int32)
    meta = (m16 & 0xFF) | ((((m16 >> 8) & 0xFF) + 1) << 16)
    return cnts, meta, gpos


@functools.partial(
    jax.jit,
    static_argnames=("max_seeds", "l_max", "occ_budget", "sa_mode", "pack16"),
)
def seed_scan_resolved_packed(fm: FMIndexArrays, words, amb_r, amb_p, rlens,
                              min_seed_len, *, max_seeds, l_max, occ_budget,
                              sa_mode="full", pack16=False):
    from .fm_search import unpack_seed_scan
    from .resolve import expand_resolve

    reads = unpack_reads_device(words, amb_r, amb_p, l_max)
    packed = seed_scan_impl(
        _occ4_pair_replicated(fm), fm.L2, fm.primary, reads, rlens,
        min_seed_len, max_seeds=max_seeds, l_max=l_max,
    )
    out = unpack_seed_scan(packed, max_seeds)
    ok = jnp.ones(reads.shape[0], bool)
    return _pack_stream(*expand_resolve(
        _resolver(fm, sa_mode), out["n_seeds"], out["rpos"], out["slen"],
        out["k0"], out["freq"], ok, occ_budget=occ_budget,
    ), pack16=pack16)


@functools.partial(
    jax.jit,
    static_argnames=("max_seeds", "l_max", "occ_budget", "sa_mode", "pack16"),
)
def sensitive_scan_resolved_packed(fm: FMIndexArrays, words, amb_r, amb_p,
                                   rlens, min_seed_len, *, max_seeds, l_max,
                                   occ_budget, sa_mode="full", pack16=False):
    from .fm_search import unpack_seed_scan
    from .resolve import expand_resolve

    reads = unpack_reads_device(words, amb_r, amb_p, l_max)
    packed = sensitive_scan_impl(
        _occ4_pair_replicated(fm), fm.L2, fm.primary, reads, rlens,
        min_seed_len, max_seeds=max_seeds, l_max=l_max,
    )
    out = unpack_seed_scan(packed, max_seeds)
    ok = jnp.ones(reads.shape[0], bool)
    return _pack_stream(*expand_resolve(
        _resolver(fm, sa_mode), out["n_seeds"], out["rpos"], out["slen"],
        out["k0"], out["freq"], ok, occ_budget=occ_budget,
    ), pack16=pack16)


@functools.partial(
    jax.jit,
    static_argnames=("max_seeds", "l_max", "hit_cap", "rounds", "seq_len",
                     "occ_budget", "sensitive", "pack16"),
)
def kmer_seed_scan_resolved_packed(table_lo, text_words, sa_full, sub_tbl,
                                   words, amb_r, amb_p, rlens, min_seed_len,
                                   *, max_seeds, l_max, hit_cap, rounds,
                                   seq_len, occ_budget, sensitive=False,
                                   pack16=False):
    from .kmer_seed import kmer_seed_scan, unpack_seed_result
    from .resolve import expand_resolve

    reads = unpack_reads_device(words, amb_r, amb_p, l_max)
    packed = kmer_seed_scan(
        table_lo, text_words, sa_full, sub_tbl, reads, rlens, min_seed_len,
        max_seeds=max_seeds, l_max=l_max, hit_cap=hit_cap, rounds=rounds,
        seq_len=seq_len, sensitive=sensitive,
    )
    out = unpack_seed_result(packed, max_seeds)
    return _pack_stream(*expand_resolve(
        lambda rows: (sa_full[rows], rows == rows),
        out["n_seeds"], out["rpos"], out["slen"], out["k0"], out["freq"],
        out["ok"], occ_budget=occ_budget,
    ), pack16=pack16)
