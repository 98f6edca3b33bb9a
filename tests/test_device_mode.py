"""Device mode fails loudly, the compile cache has a fixed home, and native
libraries rebuild for the machine that loads them (CPU tests)."""

import os

import numpy as np
import pytest

from conftest import REPO, make_genome


@pytest.fixture(scope="module")
def pe_library(workdir):
    """A 50 kb genome index and 300 read pairs drawn from it."""
    from kart_tpu.index import build_index, index_files_exist

    rng = np.random.default_rng(21)
    fa = workdir / "devmode.fa"
    prefix = workdir / "devmode_idx"
    if not index_files_exist(str(prefix)):
        fa.write_text(make_genome(rng, [50000]))
        build_index(str(fa), str(prefix), verbose=False)
    seq = "".join(l for l in fa.read_text().splitlines() if not l.startswith(">"))
    comp = str.maketrans("ACGT", "TGCA")
    r1, r2 = workdir / "devmode_1.fq", workdir / "devmode_2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i in range(300):
            p = int(rng.integers(0, len(seq) - 400))
            mate = seq[p + 250 : p + 400].translate(comp)[::-1]
            f1.write(f"@p{i}/1\n{seq[p:p + 150]}\n+\n{'I' * 150}\n")
            f2.write(f"@p{i}/2\n{mate}\n+\n{'I' * 150}\n")
    return str(prefix), str(r1), str(r2)


def _device_mapper(prefix, monkeypatch):
    from kart_tpu.index import load_index
    from kart_tpu.pipeline.mapper import KartMapper

    monkeypatch.setenv("KART_SEED_MODE", "device")
    return KartMapper(load_index(prefix))


@pytest.mark.parametrize("stage", ["_dispatch_seed_async", "_finalize_seed"])
def test_device_error_raises_instead_of_falling_back(pe_library, monkeypatch, stage):
    """A device failure at dispatch or at materialization ends the run: the
    native engine that could have finished it is ready, and is not used."""
    from kart_tpu.pipeline.mapper import KartMapper

    prefix, r1, r2 = pe_library
    mapper = _device_mapper(prefix, monkeypatch)
    assert mapper._native_seeding_ready()  # a CPU continuation was possible

    def lost(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(KartMapper, stage, lost)
    out = []
    with pytest.raises(RuntimeError, match="device lost"):
        mapper.map_stream(r1, r2, True, True, out.append)
    assert out == [] and mapper.stats["total"] == 0


def test_device_mode_refuses_implicit_cpu_backend(pe_library, monkeypatch, capsys):
    """Device mode runs on JAX's CPU backend only when jax_platforms says
    "cpu"; then it logs the device it runs on."""
    import jax

    prefix, r1, r2 = pe_library
    assert jax.config.jax_platforms == "cpu"
    try:
        jax.config.update("jax_platforms", "")
        with pytest.raises(RuntimeError, match="no accelerator"):
            _device_mapper(prefix, monkeypatch).map_stream(
                r1, r2, True, True, lambda s: None
            )
    finally:
        jax.config.update("jax_platforms", "cpu")
    mapper = _device_mapper(prefix, monkeypatch)
    out = []
    mapper.map_stream(r1, r2, True, True, out.append)
    assert mapper.stats["total"] == 600 and out
    assert "device mode on cpu (cpu)" in capsys.readouterr().err


def test_dryrun_multichip_needs_the_devices():
    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="needs 16 devices"):
        g.dryrun_multichip(16)


def test_compilation_cache_dir_choice():
    import jax

    import kart_tpu

    assert kart_tpu.compilation_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/c"}) is None
    d = kart_tpu.compilation_cache_dir({})
    assert d == kart_tpu.REPO_CACHE_DIR
    assert os.path.dirname(d) == str(REPO)
    assert "/" + os.path.basename(d) + "/" in (REPO / ".gitignore").read_text().split()
    want = os.environ.get("JAX_COMPILATION_CACHE_DIR") or d
    assert jax.config.jax_compilation_cache_dir == want


def test_native_build_key(tmp_path):
    from kart_tpu.native import build_key, host_cpu_signature

    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    cmd = ["g++", "-O3", "-march=native"]
    k = build_key(str(src), cmd)
    assert k == build_key(str(src), list(cmd), host_cpu_signature())
    assert k != build_key(str(src), cmd, host_cpu_signature() + "x")
    assert k != build_key(str(src), cmd[:-1])
    src.write_text("int f() { return 2; }\n")
    assert k != build_key(str(src), cmd)


def test_native_build_reused_only_for_same_key(tmp_path, monkeypatch):
    """build_shared reuses a library built from the same source, flags and
    CPU, and builds a new one when the CPU differs."""
    import kart_tpu.native as nat

    monkeypatch.setattr(nat, "_BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "b.cpp"
    src.write_text('extern "C" int kart_b() { return 7; }\n')
    p1 = nat.build_shared(str(src), "b", ["-O1"])
    assert p1 and os.path.basename(p1).startswith("libb-")
    assert nat.build_shared(str(src), "b", ["-O1"]) == p1
    monkeypatch.setattr(nat, "host_cpu_signature", lambda: "another cpu")
    p2 = nat.build_shared(str(src), "b", ["-O1"])
    assert p2 != p1 and os.path.exists(p2)
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        os.path.basename(p) for p in (p1, p2)
    )
