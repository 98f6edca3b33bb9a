"""Device kernels compiled for the GPU, at the widths production runs.

Each ops/pack.py entry runs at a production batch shape — Illumina
B=32,000 at l_max 160, PacBio B=640 at l_max 8,192 — and a spread of its
lanes is compared with the host FM model (ops/fm_ref.py).  The NW and a
small device-mode map are checked against their host counterparts.

Run on a machine with an NVIDIA GPU:
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
Elsewhere every test here skips.
"""

import numpy as np
import pytest

from conftest import make_genome

pytestmark = pytest.mark.gpu

ILLUMINA_B, ILLUMINA_L = 32_000, 160
PACBIO_B, PACBIO_L = 640, 8_192
MIN_SEED = 13
CHECKED_LANES = 96  # lanes per batch compared with the host model


@pytest.fixture(scope="module")
def genome(workdir):
    """A 400 kb genome with a few implanted repeats, indexed."""
    from kart_tpu.index import build_index, index_files_exist, load_index

    prefix = workdir / "gpu_idx"
    if not index_files_exist(str(prefix)):
        rng = np.random.default_rng(77)
        text = make_genome(rng, [400_000]).splitlines()
        seq = bytearray("".join(text[1:]).encode())
        unit = seq[1000:3000]
        for p in (50_000, 150_000, 250_000, 350_000):
            seq[p : p + len(unit)] = unit
        fa = workdir / "gpu.fa"
        fa.write_text(">chr1\n" + seq.decode() + "\n")
        build_index(str(fa), str(prefix), verbose=False)
    return load_index(str(prefix))


def _reads(gidx, n, l_max, lens, err, seed, indel=False):
    """(n, l_max) int8 codes of reads sampled from the text with errors,
    padded with 4, plus their lengths."""
    rng = np.random.default_rng(seed)
    codes = gidx.ref_codes
    reads = np.full((n, l_max), 4, np.int8)
    for i in range(n):
        L = lens[i % len(lens)]
        p = int(rng.integers(0, gidx.two_genome_size - 2 * L))
        src = codes[p : p + 2 * L].astype(np.int8)
        r = rng.random(len(src))
        src = np.where(r < err / 2, (src + rng.integers(1, 4, len(src))) % 4, src)
        if indel:  # 2:1:1 substitution : deletion : insertion
            keep = ~((r >= err / 2) & (r < 3 * err / 4))
            ins = ((r >= 3 * err / 4) & (r < err))[keep]
            src = np.insert(src[keep], np.nonzero(ins)[0],
                            rng.integers(0, 4, int(ins.sum())))
        reads[i, :L] = src[:L]
        if rng.random() < 0.1:
            reads[i, rng.integers(0, L)] = 4
    rl = np.array([lens[i % len(lens)] for i in range(n)], np.int32)
    return reads, rl


def _resolved_per_read(futs, B, budget, pack16):
    """Device stream -> {lane: [(rpos, len, gpos), ...]} for clean lanes."""
    from kart_tpu.ops.pack import unpack_stream
    from kart_tpu.ops.resolve import decode_resolved_counts

    cnts, meta, gpos = unpack_stream(futs, B, budget, pack16)
    ok, _, offs = decode_resolved_counts(cnts)
    out = {}
    for i in np.nonzero(ok[:B])[0]:
        seg = slice(int(offs[i]), int(offs[i + 1]))
        out[int(i)] = [
            (int(m & 0xFFFF), int(m >> 16) & 0xFFFF, int(g))
            for m, g in zip(meta[seg], gpos[seg])
        ]
    return out


def _check(got, reads, rl, want_fn):
    assert len(got) >= 0.99 * reads.shape[0], "too many flagged lanes"
    lanes = [i for i in np.linspace(0, reads.shape[0] - 1, CHECKED_LANES).astype(int)
             if i in got]
    assert len(lanes) >= CHECKED_LANES * 0.9
    for i in lanes:
        want = want_fn(reads[i, : rl[i]].astype(np.int32))
        assert got[i] == [tuple(w) for w in want], f"lane {i}"


def _run(fn, gpu, *args, **kw):
    import jax
    import jax.numpy as jnp

    from kart_tpu.ops.pack import pack_reads_2bit

    reads, rl = args[-2:]
    words, ar, ap = pack_reads_2bit(reads)
    with jax.default_device(gpu):
        futs = fn(*args[:-2], jnp.asarray(words), jnp.asarray(ar), jnp.asarray(ap),
                  jnp.asarray(rl), np.int32(MIN_SEED), **kw)
        jax.block_until_ready(futs)
    assert {d for x in jax.tree.leaves(futs) for d in x.devices()} == {gpu}
    return futs


@pytest.fixture(scope="module")
def illumina(genome):
    return _reads(genome, ILLUMINA_B, ILLUMINA_L, [150], 0.01, seed=1)


@pytest.fixture(scope="module")
def pacbio(genome):
    return _reads(genome, PACBIO_B, PACBIO_L, [5000, 6000, 7000, 8192], 0.15,
                  seed=2, indel=True)


def _fm_ref_fast(genome):
    from kart_tpu.ops.fm_ref import fm_from_genome_index, identify_seed_pairs_fast

    ref = fm_from_genome_index(genome)
    return lambda enc: identify_seed_pairs_fast(ref, enc, MIN_SEED)


def test_kmer_resolved_illumina_matches_fm_ref(gpu, genome, illumina):
    from kart_tpu.ops.kmer_seed import build_tables
    from kart_tpu.ops.pack import kmer_seed_scan_resolved_packed

    tb = build_tables(genome)
    reads, rl = illumina
    budget = 3 * ILLUMINA_B
    futs = _run(
        kmer_seed_scan_resolved_packed, gpu,
        tb.table_lo, tb.text_words, tb.sa_full, tb.sub_tbl, reads, rl,
        max_seeds=ILLUMINA_L // (MIN_SEED + 1) + 1, l_max=ILLUMINA_L,
        hit_cap=int(max(16, 1 << int(np.ceil(np.log2(tb.max_mult + 1))))),
        rounds=ILLUMINA_L // 10 + 4, seq_len=tb.seq_len, occ_budget=budget,
        pack16=True,
    )
    got = _resolved_per_read(futs, ILLUMINA_B, budget, True)
    _check(got, reads, rl, _fm_ref_fast(genome))


@pytest.mark.parametrize("sa_mode", ["full", "sampled"])
def test_fm_resolved_illumina_matches_fm_ref(gpu, genome, illumina, sa_mode):
    from kart_tpu.ops.fm_search import FMIndexArrays
    from kart_tpu.ops.pack import seed_scan_resolved_packed

    fm = FMIndexArrays.from_genome_index(genome, with_full_sa=sa_mode == "full")
    reads, rl = illumina
    budget = 3 * ILLUMINA_B
    futs = _run(
        seed_scan_resolved_packed, gpu, fm, reads, rl,
        max_seeds=ILLUMINA_L // (MIN_SEED + 1) + 1, l_max=ILLUMINA_L,
        occ_budget=budget, sa_mode=sa_mode, pack16=True,
    )
    got = _resolved_per_read(futs, ILLUMINA_B, budget, True)
    _check(got, reads, rl, _fm_ref_fast(genome))


@pytest.mark.parametrize("engine", ["kmer", "fm"])
def test_sensitive_resolved_pacbio_matches_host(gpu, genome, pacbio, engine):
    from kart_tpu.ops.fm_search import FMIndexArrays
    from kart_tpu.ops.kmer_seed import build_tables
    from kart_tpu.ops.pack import (
        kmer_seed_scan_resolved_packed,
        sensitive_scan_resolved_packed,
    )
    from kart_tpu.pipeline.mapper import KartMapper

    reads, rl = pacbio
    max_seeds = PACBIO_L // MIN_SEED + 2
    budget = PACBIO_B * max(64, PACBIO_L // 24)
    if engine == "kmer":
        tb = build_tables(genome)
        futs = _run(
            kmer_seed_scan_resolved_packed, gpu,
            tb.table_lo, tb.text_words, tb.sa_full, tb.sub_tbl, reads, rl,
            max_seeds=max_seeds, l_max=PACBIO_L,
            hit_cap=int(max(16, 1 << int(np.ceil(np.log2(tb.max_mult + 1))))),
            rounds=PACBIO_L // MIN_SEED + 8, seq_len=tb.seq_len,
            occ_budget=budget, sensitive=True,
        )
    else:
        fm = FMIndexArrays.from_genome_index(genome)
        futs = _run(
            sensitive_scan_resolved_packed, gpu, fm, reads, rl,
            max_seeds=max_seeds, l_max=PACBIO_L, occ_budget=budget,
        )
    got = _resolved_per_read(futs, PACBIO_B, budget, False)
    host = KartMapper(genome, pacbio=True, use_device=False, backend="python")
    lanes = np.linspace(0, PACBIO_B - 1, 8).astype(int)
    assert len(got) >= 0.99 * PACBIO_B, "too many flagged lanes"
    for i in lanes:
        if i in got:
            want = host._seed_sensitive_flat(reads[i, : rl[i]].astype(np.int32))
            assert got[i] == want, f"lane {i}"


def test_nw_matches_host_dp(gpu):
    import jax

    from kart_tpu.ops.nw import nw_align_batch, nw_stats
    from kart_tpu.pipeline.conquer import nw_alignment

    from test_nw_kernel import random_pairs

    rng = np.random.default_rng(5)
    pairs = []
    for lm in (16, 32, 64, 128):
        pairs += random_pairs(256, rng, max_len=lm, with_n=True)
    before = nw_stats["device"]
    with jax.default_device(gpu):
        got = nw_align_batch(pairs)
    assert nw_stats["device"] - before == len(pairs)
    for k, (a, b) in enumerate(pairs):
        assert got[k] == nw_alignment(a, b), (k, a, b)


def test_device_map_matches_native(gpu, genome, workdir, monkeypatch):
    """A small paired-end library mapped in device mode on the card gives
    the native engine's SAM byte for byte."""
    from kart_tpu import cli

    seq = genome.ref_seq[: genome.seq_len // 2].tobytes().decode()
    rng = np.random.default_rng(9)
    comp = str.maketrans("ACGT", "TGCA")
    r1, r2 = workdir / "gpu_1.fq", workdir / "gpu_2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i in range(4000):
            p = int(rng.integers(0, len(seq) - 500))
            mate = seq[p + 350 : p + 500].translate(comp)[::-1]
            f1.write(f"@p{i}/1\n{seq[p:p + 150]}\n+\n{'I' * 150}\n")
            f2.write(f"@p{i}/2\n{mate}\n+\n{'I' * 150}\n")
    args = ["kart-tpu", "-i", str(workdir / "gpu_idx"), "-f", str(r1),
            "-f2", str(r2), "-silent", "-o"]
    assert cli.main(args + [str(workdir / "gpu_native.sam")]) == 0
    monkeypatch.setenv("KART_SEED_MODE", "device")
    assert cli.main(args + [str(workdir / "gpu_device.sam")]) == 0
    native = (workdir / "gpu_native.sam").read_bytes()
    assert native.count(b"\n") > 8000
    assert (workdir / "gpu_device.sam").read_bytes() == native
