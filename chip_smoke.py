#!/usr/bin/env python3
"""Smoke run of kart-tpu's device mapping path on one NVIDIA GPU.

Maps through the entry point a user calls (`python -m kart_tpu.cli ...`
with KART_SEED_MODE=device) at the reference's own test scale, bacterial
resequencing: the seeded 4,639,680 bp repeat-bearing genome, 100,000
2x150 bp pairs and 1,500 PacBio reads of 5-7 kb at 15% error, all
generated by bench.py's generators into bench_data/ (gitignored).  Every
SAM the device writes must equal, byte for byte, the native C++ engine's
SAM of the same reads; the first 2,000 pairs must also equal the plain
Python reference pipeline (`-backend python -cpu`).

Phases, each in its own child process, one at a time on the card:
  env          the card (nvidia-smi), JAX's version and devices; must be a GPU
  gpu_tests    `pytest -m gpu tests/` (kernels at production widths)
  illumina_pe  100k pairs, device vs native; 2k pairs vs the Python reference
  pacbio       1,500 PacBio reads, device (sensitive kmer funnel) vs native
  fm_sampled   20k pairs with KART_SA_MODE=sampled: the FM stepper and the
               device inverse-Psi SA walk, device vs native
  nw           batched NW (ops/nw.py) vs the host DP, bit-exact, 4,096 pairs
               per tile size, with its time per pair
A further child, held to JAX's CPU backend, generates the data and writes
the native and reference SAMs beside them.  The parent never starts a JAX
backend.  Any failed phase ends the run with a non-zero exit code.

--four-cards runs only the multi-device path on four GPUs:
__graft_entry__.dryrun_multichip(4), and the CLI with -idx-shards 4 on 20k
pairs against the native SAM of the same reads.

The last line of standard output is
  {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}
and every number printed before it names the card and its power limit.

Usage: python3 chip_smoke.py [--four-cards]
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "smoke_data")  # gitignored
BUDGET_S = 1140  # the whole run, compilation included

SUBSETS = {"pe2k": 2_000, "pe20k": 20_000}  # leading pairs of the 100k library
NW_PAIRS = 4096
NW_TILES = (16, 32, 64, 128)


def _out(name):
    return os.path.join(OUT, name)


def _report(msg):
    print(f"[{os.environ['SMOKE_CARD']}] {msg}", flush=True)


def _same(got, want):
    """Byte equality of two SAM files, with the first difference on failure."""
    a, b = open(got, "rb").read(), open(want, "rb").read()
    if a == b:
        return
    la, lb = a.splitlines(), b.splitlines()
    first = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y), min(len(la), len(lb)))
    raise AssertionError(
        f"{os.path.basename(got)} != {os.path.basename(want)}: {len(la)} vs {len(lb)} "
        f"lines, first difference at line {first + 1}:\n"
        f"  {la[first][:200] if first < len(la) else b'<eof>'}\n"
        f"  {lb[first][:200] if first < len(lb) else b'<eof>'}"
    )


def _assets():
    """bench.py's generated workload: index prefix, r1, r2, PacBio reads."""
    sys.path.insert(0, REPO)
    import bench

    return (os.path.join(bench.DATA, "bench_idx_v2"),
            os.path.join(bench.DATA, "bench_v2_r1.fq"),
            os.path.join(bench.DATA, "bench_v2_r2.fq"),
            os.path.join(bench.DATA, "bench_pb.fq"))


def _cli(*args):
    return ["-i", _assets()[0], *args, "-silent"]


def _pe(name):
    """-f/-f2 arguments of a paired library: the full 100k or a subset."""
    if name == "pe100k":
        _, r1, r2, _ = _assets()
        return ["-f", r1, "-f2", r2]
    return ["-f", _out(f"{name}_1.fq"), "-f2", _out(f"{name}_2.fq")]


# ---------------------------------------------------------------------------
# CPU child: data, native SAMs, reference SAM
# ---------------------------------------------------------------------------


def phase_prep(four_cards):
    sys.path.insert(0, REPO)
    import bench
    from kart_tpu.index import load_index
    from kart_tpu.ops.kmer_seed import build_tables

    prefix, r1, r2 = bench.ensure_assets()
    for name, n in SUBSETS.items():
        for src, mate in ((r1, 1), (r2, 2)):
            with open(src, "rb") as f, open(_out(f"{name}_{mate}.fq"), "wb") as g:
                for _ in range(4 * n):
                    g.write(f.readline())
    # the .kmt sidecar is written once here, before any concurrent reader
    build_tables(load_index(prefix))
    if four_cards:
        jobs = {"pe20k.native.sam": (_cli(*_pe("pe20k")), {})}
    else:
        pb = bench.ensure_pacbio_assets(os.path.join(bench.DATA, "bench_genome_v2.fa"))
        jobs = {
            "pe100k.native.sam": (_cli(*_pe("pe100k")), {}),
            "pe2k.ref.sam": (_cli(*_pe("pe2k"), "-backend", "python", "-cpu"), {}),
            "pb.native.sam": (_cli("-pacbio", "-f", pb), {}),
            "pe20k.sampled.native.sam": (_cli(*_pe("pe20k")), {"KART_SA_MODE": "sampled"}),
        }
    env = {k: v for k, v in os.environ.items() if not k.startswith("KART_")}
    procs = {}
    for out, (args, extra) in jobs.items():
        procs[out] = (time.time(), subprocess.Popen(
            [sys.executable, "-m", "kart_tpu.cli", *args, "-o", _out(out)],
            cwd=REPO, env={**env, **extra, "JAX_PLATFORMS": "cpu"},
            stdout=subprocess.DEVNULL,
        ))
    for out, (t0, p) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{out}: kart_tpu.cli exited {p.returncode}")
        print(f"prep: {out} written in {time.time() - t0:.1f} s (host CPU, "
              f"{len(procs)} jobs at once)", flush=True)


# ---------------------------------------------------------------------------
# GPU children
# ---------------------------------------------------------------------------


def phase_env(four_cards):
    import jax

    devs = jax.devices()
    _report(f"jax {jax.__version__}; devices: {devs}")
    d = devs[0]
    assert d.platform == "gpu", f"JAX's default backend is {d.platform}, not a GPU"
    need = 4 if four_cards else 1
    assert len(devs) >= need, f"{len(devs)} GPUs, need {need}"
    with open(_out("device.json"), "w") as f:
        json.dump({"platform": d.platform, "kind": d.device_kind, "count": len(devs)}, f)


class _Recorder:
    """Wraps a function attribute and keeps what each call saw."""

    def __init__(self, owner, name, keep):
        self.owner, self.name, self.keep, self.calls = owner, name, keep, []
        self.fn = getattr(owner, name)
        setattr(owner, name, self)

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        self.calls.append((self.keep(args, kwargs), time.perf_counter() - t0))
        return out

    def __get__(self, obj, cls):  # bound like the method it replaces
        return self if obj is None else lambda *a, **k: self(obj, *a, **k)


def _device_map(args, out, label):
    """One device-mode CLI run in this process.  Returns the mapper and the
    calls of the packed kmer entry point."""
    import jax

    import kart_tpu.ops.pack as pack
    from kart_tpu import cli
    from kart_tpu.pipeline.mapper import KartMapper

    compile_s = [0.0]

    def on_event(event, secs, **kw):
        if event.startswith("/jax/core/compile/"):
            compile_s[0] += secs

    jax.monitoring.register_event_duration_secs_listener(on_event)
    streams = _Recorder(KartMapper, "map_stream", lambda a, k: a[0])
    kmer = _Recorder(pack, "kmer_seed_scan_resolved_packed", lambda a, k: (a, k))
    fm = _Recorder(pack, "seed_scan_resolved_packed", lambda a, k: k["sa_mode"])
    os.environ["KART_SEED_MODE"] = "device"
    try:
        assert cli.main(["kart-tpu", *args, "-o", _out(out)]) == 0
    finally:
        del os.environ["KART_SEED_MODE"]
        for r in (streams, kmer, fm):
            setattr(r.owner, r.name, r.fn)
        jax.monitoring.unregister_event_duration_listener(on_event)
    (mapper, secs), = streams.calls
    n_reads = mapper.stats["total"]
    _report(
        f"{label}: {n_reads} reads in {secs:.2f} s = {n_reads / secs:,.0f} reads/s "
        f"(includes {compile_s[0]:.1f} s of JAX trace/lower/compile); "
        f"{mapper.lanes_reseeded} lanes re-seeded; {len(kmer.calls)} kmer / "
        f"{len(fm.calls)} FM dispatches"
    )
    assert mapper.native is not None, "the native engine did not load"
    return mapper, kmer.calls, fm.calls


def _memory_report(kmer_calls):
    import jax

    import kart_tpu.ops.pack as pack

    (args, kwargs), _ = max(kmer_calls, key=lambda c: c[0][0][4].shape[0])
    ma = pack.kmer_seed_scan_resolved_packed.lower(*args, **kwargs).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    _report(
        f"kmer_seed_scan_resolved_packed at B={args[4].shape[0]}, "
        f"l_max={kwargs['l_max']}: memory_analysis "
        + ", ".join(f"{f}={getattr(ma, f, 'n/a')}" for f in fields)
    )
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    _report(f"device peak_bytes_in_use after the run: {peak}")


def phase_illumina_pe(four_cards):
    mapper, kmer_calls, _ = _device_map(
        _cli(*_pe("pe100k")), "pe100k.device.sam", "illumina_pe 2x150 device"
    )
    assert mapper._get_kmer_tables() is not None, "the kmer engine did not run"
    assert kmer_calls, "no kmer dispatch reached the device"
    _same(_out("pe100k.device.sam"), _out("pe100k.native.sam"))
    _report(f"illumina_pe: device SAM == native SAM ({mapper.stats['total'] // 2} pairs)")
    _memory_report(kmer_calls)
    mapper, _, _ = _device_map(_cli(*_pe("pe2k")), "pe2k.device.sam", "illumina_pe subset device")
    _same(_out("pe2k.device.sam"), _out("pe2k.ref.sam"))
    _report("illumina_pe: device SAM == Python reference SAM "
            f"({mapper.stats['total'] // 2} pairs)")


def phase_pacbio(four_cards):
    pb = _assets()[3]
    mapper, kmer_calls, _ = _device_map(
        _cli("-pacbio", "-f", pb), "pb.device.sam", "pacbio device"
    )
    assert mapper._get_kmer_tables() is not None, "the kmer engine did not run"
    assert any(k.get("sensitive") for (a, k), _ in kmer_calls), "no sensitive funnel"
    _same(_out("pb.device.sam"), _out("pb.native.sam"))
    _report(f"pacbio: device SAM == native SAM ({mapper.stats['total']} reads)")


def phase_fm_sampled(four_cards):
    os.environ["KART_SA_MODE"] = "sampled"
    mapper, kmer_calls, fm_calls = _device_map(
        _cli(*_pe("pe20k")), "pe20k.sampled.device.sam", "fm_sampled device"
    )
    assert mapper.sa_mode == "sampled" and mapper._get_kmer_tables() is None
    assert not kmer_calls and {m for m, _ in fm_calls} == {"sampled"}, fm_calls
    _same(_out("pe20k.sampled.device.sam"), _out("pe20k.sampled.native.sam"))
    _report(f"fm_sampled: device SAM == native SAM ({mapper.stats['total'] // 2} pairs)")


def _nw_pairs(rng, lm, n):
    """n related fragment pairs whose longer side falls in (lm/2, lm]."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(n):
        la = int(rng.integers(lm // 2 + 1, lm + 1))
        a = bases[rng.integers(0, 4, la)]
        b = a.copy()
        k = rng.random(la)
        b[k < 0.1] = bases[rng.integers(0, 4, int((k < 0.1).sum()))]
        b = np.delete(b, np.nonzero((k >= 0.1) & (k < 0.13))[0])
        pairs.append((a.tobytes(), b.tobytes()))
    return pairs


def phase_nw(four_cards):
    import ctypes

    import jax
    import jax.numpy as jnp
    import numpy as np

    from kart_tpu.native.post import load_postlib
    from kart_tpu.ops.nw import encode_tile, nw_align_batch, nw_batch_planes
    from kart_tpu.pipeline.conquer import nw_alignment

    lib = load_postlib()
    assert lib is not None, "the native engine did not load"
    buf = ctypes.create_string_buffer(4096)
    rng = np.random.default_rng(31)
    for lm in NW_TILES:
        pairs = _nw_pairs(rng, lm, NW_PAIRS)
        got = nw_align_batch(pairs)  # compiles this tile size
        bad = [k for k, p in enumerate(pairs) if got[k] != nw_alignment(*p)]
        assert not bad, f"lm={lm}: {len(bad)} pairs differ from the host DP, first {bad[:5]}"
        c1, c2 = (jnp.asarray(c) for c in encode_tile(pairs, lm))
        jax.block_until_ready(nw_batch_planes(c1, c2, lm=lm))
        t0 = time.perf_counter()
        for _ in range(5):
            jax.block_until_ready(nw_batch_planes(c1, c2, lm=lm))
        dev_s = (time.perf_counter() - t0) / 5
        t0 = time.perf_counter()
        nw_align_batch(pairs)
        batch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for a, b in pairs:
            lib.kart_nw_debug(a, b, ctypes.c_int32(0), buf, ctypes.c_int64(len(buf)))
        nat_s = time.perf_counter() - t0
        _report(
            f"nw lm={lm}: {NW_PAIRS} pairs bit-exact vs the host DP; device DP "
            f"{1e6 * dev_s / NW_PAIRS:.3f} us/pair, nw_align_batch with host "
            f"backtrace {1e6 * batch_s / NW_PAIRS:.1f} us/pair, native AVX2 NW "
            f"(host CPU, one thread, via ctypes) {1e6 * nat_s / NW_PAIRS:.1f} us/pair"
        )


def phase_four(four_cards):
    import jax

    import __graft_entry__
    from kart_tpu import cli

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    _report(f"dryrun_multichip(4) passed in {time.perf_counter() - t0:.1f} s "
            f"on {jax.devices()[:4]}")
    from kart_tpu.pipeline.mapper import KartMapper

    t0 = time.perf_counter()
    out = _out("pe20k.shards4.sam")
    streams = _Recorder(KartMapper, "map_stream", lambda a, k: a[0])
    try:
        assert cli.main(["kart-tpu", *_cli(*_pe("pe20k")), "-idx-shards", "4", "-o", out]) == 0
    finally:
        setattr(KartMapper, "map_stream", streams.fn)
    secs = time.perf_counter() - t0
    (mapper, _), = streams.calls
    _, sfm, *_ = mapper._get_sharded()
    spread = {  # field -> (device, shard length) of each quarter it holds
        f: sorted((x.device.id, x.data.shape[0]) for x in getattr(sfm, f).addressable_shards)
        for f in ("occ_cp", "bwt_words", "sa_full")
    }
    _report(f"-idx-shards 4: index shards (device, length) {spread}")
    for f, shards in spread.items():
        n = getattr(sfm, f).shape[0]
        assert [d for d, _ in shards] == [0, 1, 2, 3] and all(
            4 * m == n for _, m in shards), (f, n, shards)
    n = sum(1 for line in open(out, "rb") if not line.startswith(b"@"))
    _report(f"-idx-shards 4: {n} reads in {secs:.1f} s (first run, index load and "
            "compile included)")
    _same(out, _out("pe20k.native.sam"))
    _report(f"-idx-shards 4 SAM == native SAM ({n // 2} pairs)")


PHASES = {
    "prep": phase_prep,
    "env": phase_env,
    "nw": phase_nw,
    "illumina_pe": phase_illumina_pe,
    "pacbio": phase_pacbio,
    "fm_sampled": phase_fm_sampled,
    "four": phase_four,
}


# ---------------------------------------------------------------------------
# Parent
# ---------------------------------------------------------------------------


def _card():
    """Name and power limit of every GPU, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return "; ".join(line.strip() for line in out)


def _gpu_tests_ok():
    """The junit record of the gpu tests: all ran, none skipped."""
    import xml.etree.ElementTree as ET

    suite = ET.parse(_out("gpu_tests.xml")).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n, skipped = int(suite.get("tests")), int(suite.get("skipped"))
    assert n >= 7 and skipped == 0, f"gpu tests: {n} collected, {skipped} skipped"
    return n


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--phase", choices=sorted(PHASES), help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.phase:
        PHASES[opts.phase](opts.four_cards)
        return 0
    if not os.path.isdir(os.path.join(REPO, "kart_tpu")):
        print("chip_smoke.py runs from a kart-tpu checkout", file=sys.stderr)
        return 2
    deadline = time.time() + BUDGET_S
    os.makedirs(OUT, exist_ok=True)
    card = _card()
    print(f"card: {card}", flush=True)
    env = {**os.environ, "SMOKE_CARD": card}
    four = ["--four-cards"] if opts.four_cards else []

    def child(name):
        return [sys.executable, os.path.abspath(__file__), "--phase", name, *four]

    def run(name, cmd, extra_env=None):
        t0 = time.time()
        try:
            rc = subprocess.run(cmd, cwd=REPO, env={**env, **(extra_env or {})},
                                timeout=max(1, deadline - time.time())).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        print(f"== phase {name}: rc={rc} in {time.time() - t0:.1f} s", flush=True)
        if rc != 0:
            raise SystemExit(f"phase {name} failed (rc={rc})")

    prep = subprocess.Popen(child("prep"), cwd=REPO, env={**env, "JAX_PLATFORMS": "cpu"})
    try:
        run("env", child("env"))
        if opts.four_cards:
            gpu_phases = ["four"]
        else:
            run("gpu_tests", [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q", "-x",
                              "-p", "no:cacheprovider", "-p", "no:xdist",
                              f"--junitxml={_out('gpu_tests.xml')}"],
                {"JAX_PLATFORMS": "cuda,cpu"})
            print(f"gpu tests: {_gpu_tests_ok()} passed, none skipped", flush=True)
            # nw times the host's native NW too: it runs after prep's CPU jobs
            gpu_phases = ["nw", "illumina_pe", "pacbio", "fm_sampled"]
        t0 = time.time()
        rc = prep.wait(timeout=max(1, deadline - time.time()))
        print(f"== phase prep: rc={rc}, waited {time.time() - t0:.1f} s", flush=True)
        if rc != 0:
            raise SystemExit(f"phase prep failed (rc={rc})")
        for name in gpu_phases:
            run(name, child(name))
    finally:
        if prep.poll() is None:
            prep.kill()
            prep.wait()
    with open(_out("device.json")) as f:
        device = json.load(f)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
