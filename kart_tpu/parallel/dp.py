"""Multi-chip mapping step: data-parallel reads × (optionally) sharded index.

This is the SPMD equivalent of the reference's only parallelism — N pthreads
over read chunks with a shared read-only index (reference: src/Mapping.cpp:
488-742) — recast as SPMD over a jax.sharding.Mesh:

  * reads are the batch dimension, sharded along the `data` axis;
  * the FM-index is either replicated (small genomes — the per-thread
    shared-index model) or block-sharded along an `idx` axis (human-scale
    genomes), in which case every Occ/SA lookup is a masked local lookup +
    psum over `idx` across the devices (see parallel.sharded_index);
  * the reference's mutex-guarded global counters (iTotalReadNum etc.,
    src/Mapping.cpp:20) become a psum over `data`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.fm_search import FMIndexArrays, seed_scan, seed_scan_impl
from .sharded_index import build_sharded_fm, sharded_sa_gather, sharded_seed_scan


def make_mapping_step(
    mesh: Mesh,
    gidx,
    *,
    data_axis: str = "data",
    idx_axis: str | None = None,
    min_seed_len: int,
    max_seeds: int,
    l_max: int,
):
    """Build the jitted device mapping step over `mesh`.

    Returns (step, place_reads) where
      step(reads, rlens) -> (packed_seeds, locs, total_seeds)
        packed_seeds (B, 1+4*max_seeds) int32  seed blocks per read
        locs         (B, max_seeds)     int32  text position of each seed's
                                               first occurrence (SA-resolved)
        total_seeds  ()                 int32  global count (psum over data)
      place_reads(reads, rlens) puts host batches on the mesh with the
        right shardings (data-sharded, replicated along idx).
    """
    msl = jnp.int32(min_seed_len)

    if idx_axis is None:
        fm = FMIndexArrays.from_genome_index(gidx, sharding=NamedSharding(mesh, P()))

        def local_step(fm_l, reads, rlens):
            packed = seed_scan(
                fm_l, reads, rlens, msl, max_seeds=max_seeds, l_max=l_max
            )
            k0 = packed[:, 1 + 2 * max_seeds : 1 + 3 * max_seeds]
            locs = fm_l.sa_full[k0]
            total = jax.lax.psum(jnp.sum(packed[:, 0]), data_axis)
            return packed, locs, total

        step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(P(), P(data_axis), P(data_axis)),
                out_specs=(P(data_axis), P(data_axis), P()),
            )
        )
        index_arg = fm
    else:
        n_shards = mesh.shape[idx_axis]
        sfm_host, geom = build_sharded_fm(gidx, n_shards)
        nb_local = geom["nb_local"]
        ns_local = geom["ns_local"]
        sfm = place_sharded_fm(jax.tree.map(jnp.asarray, sfm_host), mesh, idx_axis)

        def local_step(sfm_l, reads, rlens):
            packed = sharded_seed_scan(
                sfm_l, nb_local, idx_axis, reads, rlens, msl,
                max_seeds=max_seeds, l_max=l_max,
            )
            k0 = packed[:, 1 + 2 * max_seeds : 1 + 3 * max_seeds]
            locs = sharded_sa_gather(sfm_l.sa_full, ns_local, idx_axis, k0)
            total = jax.lax.psum(jnp.sum(packed[:, 0]), data_axis)
            return packed, locs, total

        step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(
                    ShardedFMSpecs(idx_axis),
                    P(data_axis),
                    P(data_axis),
                ),
                out_specs=(P(data_axis), P(data_axis), P()),
            )
        )
        index_arg = sfm

    batch_sharding = NamedSharding(mesh, P(data_axis))

    def place_reads(reads, rlens):
        return (
            jax.device_put(jnp.asarray(reads), batch_sharding),
            jax.device_put(jnp.asarray(rlens), batch_sharding),
        )

    return functools.partial(step, index_arg), place_reads


def _sorted_occurrences(cnts, meta, gpos, B: int, s_occ: int):
    """Scatter the flat resolved occurrence stream back to per-read (B,
    s_occ) slots and sort each read's occurrences by (posdiff, rpos) — the
    host pipeline's PosDiff sort before clustering (CompByPosDiff,
    reference src/AlignmentCandidates.cpp:11-15)."""
    H = meta.shape[0]
    idt = gpos.dtype
    big = jnp.iinfo(idt).max
    tot = jnp.maximum(cnts, 0)
    offs = jnp.cumsum(tot) - tot  # (B,) stream start per read
    jh = jnp.arange(H, dtype=jnp.int32)
    lane = jnp.searchsorted(jnp.cumsum(tot), jh, side="right").astype(jnp.int32)
    lane_c = jnp.minimum(lane, B - 1)
    slot = jh - offs[lane_c]
    # meta packs rpos | slen<<16 as raw uint32 bits in an int32: a valid
    # slen can reach 32768 (PacBio exact seed) which sets the sign bit, so
    # validity is "slen field != 0xFFFF" (the -1 fill), NOT meta >= 0
    ln = (meta >> 16) & 0xFFFF
    valid = (ln != 0xFFFF) & (slot < s_occ) & (lane < B)
    rp = meta & 0xFFFF
    pd = gpos - rp.astype(idt)
    tgt = (lane_c, jnp.where(valid, slot, s_occ))

    def scat(vals, fill, dt):
        return (
            jnp.full((B, s_occ), fill, dt)
            .at[tgt]
            .set(jnp.where(valid, vals, fill), mode="drop")
        )

    pd_b = scat(pd, big, idt)
    rp_b = scat(rp, jnp.int32(2**31 - 1), jnp.int32)
    ln_b = scat(ln, 0, jnp.int32)
    gp_b = scat(gpos, 0, idt)
    # lexicographic (posdiff, rpos) via composed STABLE argsorts (no packed
    # wide key: stays int32-clean for small-genome indexes)
    o1 = jnp.argsort(rp_b, axis=1, stable=True)
    o2 = jnp.argsort(jnp.take_along_axis(pd_b, o1, axis=1), axis=1, stable=True)
    order = jnp.take_along_axis(o1, o2, axis=1)
    pd_s = jnp.take_along_axis(pd_b, order, axis=1)
    rp_s = jnp.take_along_axis(rp_b, order, axis=1)
    ln_s = jnp.take_along_axis(ln_b, order, axis=1)
    gp_s = jnp.take_along_axis(gp_b, order, axis=1)
    present = pd_s < big
    n_occ = present.sum(axis=1).astype(jnp.int32)
    return n_occ, rp_s, ln_s, gp_s, pd_s.astype(jnp.int32), present


def make_full_mapping_step(
    mesh: Mesh,
    gidx,
    *,
    data_axis: str = "data",
    idx_axis: str | None = None,
    min_seed_len: int,
    max_seeds: int,
    l_max: int,
    s_occ: int = 16,
    max_gaps: int = 5,
    est_distance: int = 1500,
    sa_mode: str = "full",
):
    """The WHOLE device mapping front half over `mesh`: FastMode seeding ->
    on-device occurrence expansion + SA resolution (full-SA gather on the
    replicated index; masked-psum `sharded_sa_gather` when the index is
    block-sharded along `idx_axis`) -> PosDiff sort -> candidate clustering
    (ops/cluster.py) -> paired-end mating (ops/pairing.py), all inside one
    shard_map.  Reads are data-parallel; consecutive (even, odd) rows form
    a PE pair.

    step(reads, rlens) ->
      (cnts, meta, gpos)            resolved occurrence stream (per shard
                                    budget: 4 * B_local)
      (cluster_id, accept, scores)  per-read clustering
      (paired1, paired2, pairing)   PE mating of accepted clusters

    CONTRACT (ADVICE r4): cnts[i] < 0 flags read i as overflowing the
    shard's occurrence budget — and because the budget check is a prefix
    sum, every read AFTER the first overflow in the shard is flagged too.
    A flagged read's clustering/pairing outputs are computed from zero
    occurrences and are NOT valid.  Callers must check `(cnts < 0).any()`
    and re-seed flagged reads (the production mapper re-seeds via
    `_reseed_device_flat`; `__graft_entry__.dryrun_multichip` asserts no
    flags at its shapes).
    """
    from ..ops.cluster import cluster_illumina
    from ..ops.pairing import pair_candidates
    from ..ops.fm_search import unpack_seed_scan
    from ..ops.resolve import expand_resolve

    msl = jnp.int32(min_seed_len)
    keys, _ = gidx.chr_map
    chr_keys = jnp.asarray(keys.astype(np.int32))

    def front_half(occ4_pair, sa_lookup, L2, primary, reads, rlens):
        B = reads.shape[0]
        packed = seed_scan_impl(
            occ4_pair, L2, primary, reads.astype(jnp.int32), rlens, msl,
            max_seeds=max_seeds, l_max=l_max,
        )
        out = unpack_seed_scan(packed, max_seeds)
        cnts, meta, gpos = expand_resolve(
            sa_lookup, out["n_seeds"], out["rpos"], out["slen"], out["k0"],
            out["freq"], jnp.ones(B, bool), occ_budget=4 * B,
        )
        n_occ, rp_s, ln_s, gp_s, pd_s, present = _sorted_occurrences(
            cnts, meta, gpos, B, s_occ
        )
        thr0 = jnp.minimum((rlens * 2) // 10, 50)
        pd_in = jnp.where(present, pd_s, jnp.int32(2**31 - 1))
        cid, accept, scores = cluster_illumina(
            chr_keys, pd_in, gp_s.astype(jnp.int32), ln_s, n_occ, thr0,
            jnp.int32(max_gaps), max_seeds=s_occ,
        )
        # candidate posdiff = first member seed's posdiff clamped >= 0
        first_pd = (
            jnp.full((B, s_occ), jnp.int32(2**31 - 1))
            .at[
                jnp.broadcast_to(jnp.arange(B)[:, None], (B, s_occ)),
                jnp.where(cid >= 0, cid, s_occ),
            ]
            .min(jnp.where(present, pd_s, 2**31 - 1), mode="drop")
        )
        cand_pd = jnp.maximum(jnp.where(accept, first_pd, 0), 0)
        cand_sc = jnp.where(accept, scores, 0)
        # PE mating: rows (0,1), (2,3), ... are mates
        s1 = cand_sc[0::2]
        s2 = cand_sc[1::2]
        d1 = cand_pd[0::2]
        d2 = cand_pd[1::2]
        paired1, paired2, pairing = pair_candidates(
            s1, d1, s2, d2, jnp.int32(est_distance)
        )
        return (
            (cnts, meta, gpos),
            (cid, accept, scores),
            (paired1, paired2, pairing),
        )

    if idx_axis is None:
        fm = FMIndexArrays.from_genome_index(
            gidx, sharding=NamedSharding(mesh, P()),
            with_full_sa=(None if sa_mode == "full" else False),
        )
        from ..ops.fm_search import _occ4_pair_replicated, sa_walk

        def local_step(fm_l, reads, rlens):
            if fm_l.sa_full is not None:
                lookup = lambda rows: (fm_l.sa_full[rows], rows == rows)
            else:
                lookup = lambda rows: sa_walk(fm_l, rows)
            return front_half(
                _occ4_pair_replicated(fm_l),
                lookup,
                fm_l.L2, fm_l.primary, reads, rlens,
            )

        step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(P(), P(data_axis), P(data_axis)),
                out_specs=(
                    (P(data_axis), P(data_axis), P(data_axis)),
                    (P(data_axis), P(data_axis), P(data_axis)),
                    (P(data_axis), P(data_axis), P(data_axis)),
                ),
            )
        )
        index_arg = fm
    else:
        n_shards = mesh.shape[idx_axis]
        sfm_host, geom = build_sharded_fm(gidx, n_shards, sa_mode=sa_mode)
        nb_local = geom["nb_local"]
        ns_local = geom["ns_local"]
        nsamp_local = geom["nsamp_local"]
        sfm = place_sharded_fm(
            jax.tree.map(jnp.asarray, sfm_host), mesh, idx_axis
        )

        def local_step(sfm_l, reads, rlens):
            from .sharded_index import sharded_occ4_pair, sharded_sa_walk

            if sfm_l.sa_full is not None:
                lookup = lambda rows: (
                    sharded_sa_gather(sfm_l.sa_full, ns_local, idx_axis, rows),
                    rows == rows,
                )
            else:
                # frugal resolver: sharded inverse-Psi walk over the
                # sharded intv-32 samples — no full SA anywhere
                lookup = lambda rows: sharded_sa_walk(
                    sfm_l, nb_local, nsamp_local, idx_axis, rows
                )
            return front_half(
                lambda ka, kb: sharded_occ4_pair(sfm_l, nb_local, idx_axis, ka, kb),
                lookup,
                sfm_l.L2, sfm_l.primary, reads, rlens,
            )

        step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(ShardedFMSpecs(idx_axis, sa_mode == "full"),
                          P(data_axis), P(data_axis)),
                out_specs=(
                    (P(data_axis), P(data_axis), P(data_axis)),
                    (P(data_axis), P(data_axis), P(data_axis)),
                    (P(data_axis), P(data_axis), P(data_axis)),
                ),
            )
        )
        index_arg = sfm

    batch_sharding = NamedSharding(mesh, P(data_axis))

    def place_reads(reads, rlens):
        return (
            jax.device_put(jnp.asarray(reads), batch_sharding),
            jax.device_put(jnp.asarray(rlens), batch_sharding),
        )

    return functools.partial(step, index_arg), place_reads


def ShardedFMSpecs(idx_axis: str, with_full_sa: bool = True):
    """PartitionSpecs pytree matching ShardedFM's flattened children.
    with_full_sa=False matches the frugal build (sa_full is None and
    flattens away as an empty subtree)."""
    from .sharded_index import ShardedFM

    return ShardedFM(
        occ_cp=P(idx_axis),
        bwt_words=P(idx_axis),
        sa_full=P(idx_axis) if with_full_sa else None,
        sa_samples=P(idx_axis),
        L2=P(),
        primary=P(),
        seq_len=P(),
    )


def place_sharded_fm(sfm, mesh, idx_axis: str):
    """device_put every ShardedFM child with its production sharding
    (block-sharded big arrays along `idx_axis`, replicated scalars)."""
    shard1 = NamedSharding(mesh, P(idx_axis))
    repl = NamedSharding(mesh, P())
    sfm.occ_cp = jax.device_put(sfm.occ_cp, shard1)
    sfm.bwt_words = jax.device_put(sfm.bwt_words, shard1)
    if sfm.sa_full is not None:
        sfm.sa_full = jax.device_put(sfm.sa_full, shard1)
    sfm.sa_samples = jax.device_put(sfm.sa_samples, shard1)
    sfm.L2 = jax.device_put(jnp.asarray(sfm.L2), repl)
    sfm.primary = jax.device_put(jnp.asarray(sfm.primary), repl)
    sfm.seq_len = jax.device_put(jnp.asarray(sfm.seq_len), repl)
    return sfm


def make_data_mesh(n_data: int, n_idx: int = 1, devices=None) -> Mesh:
    """A (data[, idx]) mesh over the first n_data*n_idx local devices."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_idx
    devs = np.array(devices[:need])
    if n_idx == 1:
        return Mesh(devs, ("data",))
    return Mesh(devs.reshape(n_data, n_idx), ("data", "idx"))
