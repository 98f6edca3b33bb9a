"""Batched plain-JAX NW (ops/nw.py) vs the host reference DP (bit-exact)."""

import numpy as np
import pytest

from kart_tpu.pipeline.conquer import nw_alignment


def random_pairs(n, rng, max_len=30, err=0.15, with_n=False):
    pairs = []
    for _ in range(n):
        la = int(rng.integers(1, max_len + 1))
        a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=la)
        # derive b from a with subs/indels so alignments are non-trivial
        b = []
        for c in a:
            r = rng.random()
            if r < err * 0.4:
                continue  # deletion
            if r < err * 0.7:
                b.append(int(rng.choice(np.frombuffer(b"ACGT", np.uint8))))
            else:
                b.append(int(c))
            if rng.random() < err * 0.3:
                b.append(int(rng.choice(np.frombuffer(b"ACGT", np.uint8))))
        if not b:
            b = [int(a[0])]
        a = a.tobytes()
        b = bytes(b)
        if with_n and rng.random() < 0.5:
            a = a[: la // 2] + b"N" + a[la // 2 :]
        pairs.append((a, b[:max_len]))
    return pairs


def test_nw_kernel_matches_host():
    from kart_tpu.ops.nw import nw_align_batch

    rng = np.random.default_rng(7)
    pairs = random_pairs(300, rng)
    got = nw_align_batch(pairs)
    for k, (a, b) in enumerate(pairs):
        want = nw_alignment(a, b)
        assert got[k] == want, (k, a, b, got[k], want)


def test_nw_kernel_ambiguous_and_sizes():
    from kart_tpu.ops.nw import nw_align_batch

    rng = np.random.default_rng(11)
    pairs = random_pairs(40, rng, max_len=60, with_n=True)
    pairs += [(b"A", b"A"), (b"A", b"T"), (b"ACGT", b"A"), (b"A", b"ACGT")]
    got = nw_align_batch(pairs)
    for k, (a, b) in enumerate(pairs):
        assert got[k] == nw_alignment(a, b), (k, a, b)


def test_nw_kernel_empty_batch():
    from kart_tpu.ops.nw import nw_align_batch

    assert nw_align_batch([]) == []


def test_nw_wavefront_tiles_match_host():
    """64/128 tiles (PacBio conquer fragment sizes) bit-match the host DP,
    including coverage accounting."""
    from kart_tpu.ops.nw import nw_align_batch, nw_stats

    rng = np.random.default_rng(13)
    pairs = random_pairs(48, rng, max_len=64)
    pairs += random_pairs(24, rng, max_len=128)
    pairs += [(b"A" * 64, b"A" * 33), (b"ACGT" * 32, b"ACGT" * 16)]
    before = dict(nw_stats)
    got = nw_align_batch(pairs)
    assert nw_stats["device"] - before["device"] == len(pairs)
    for k, (a, b) in enumerate(pairs):
        assert got[k] == nw_alignment(a, b), (k, len(a), len(b))


def test_nw_beyond_tiles_host_fallback():
    from kart_tpu.ops.nw import nw_align_batch, nw_stats

    rng = np.random.default_rng(17)
    pairs = random_pairs(4, rng, max_len=200)
    pairs = [p for p in pairs if max(len(p[0]), len(p[1])) > 128] or [
        (b"ACGT" * 40, b"ACGT" * 35)
    ]
    before = dict(nw_stats)
    got = nw_align_batch(pairs)
    assert nw_stats["host"] - before["host"] == len(pairs)
    for k, (a, b) in enumerate(pairs):
        assert got[k] == nw_alignment(a, b)


def test_native_nw_simd_matches_scalar_fuzz():
    """The native AVX2 anti-diagonal NW must produce the identical aligned
    pair (same backtrace, not just same score) as the scalar rolling-row
    DP on thousands of random fragment pairs spanning the production size
    range (2..300 bp, equal and skewed lengths, shared prefixes like real
    conquer fragments)."""
    import ctypes

    from kart_tpu.native.post import load_postlib

    lib = load_postlib()
    if lib is None:
        import pytest

        pytest.skip("native library unavailable")

    def run(a: bytes, b: bytes, scalar: int):
        cap = 4 * (len(a) + len(b) + 4)
        buf = ctypes.create_string_buffer(cap)
        n = lib.kart_nw_debug(a, b, ctypes.c_int32(scalar), buf, ctypes.c_int64(cap))
        assert n <= cap
        raw = buf.raw[: n - 1]
        s1, s2 = raw.split(b"\0", 1)
        return s1, s2.rstrip(b"\0")

    rng = np.random.default_rng(99)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    def frag(L):
        return bases[rng.integers(0, 4, L)].tobytes()

    cases = []
    for _ in range(800):
        la = int(rng.integers(2, 40))
        lb = max(1, la + int(rng.integers(-5, 6)))
        a = frag(la)
        # related fragment: share content with errors (like real conquer input)
        b = bytearray(a[:lb].ljust(lb, b"A"))
        for _ in range(int(rng.integers(0, 4))):
            b[rng.integers(0, lb)] = bases[rng.integers(0, 4)]
        cases.append((a, bytes(b)))
    for _ in range(200):
        la = int(rng.integers(8, 300))
        lb = int(rng.integers(8, 300))
        cases.append((frag(la), frag(lb)))
    cases += [(b"A" * 8, b"A" * 8), (b"ACGTACGT", b"TGCATGCA"),
              (b"A" * 299, b"A" * 7), (b"A" * 7, b"C" * 299)]
    for a, b in cases:
        assert run(a, b, 0) == run(a, b, 1), (a, b)
