import os
import warnings

# The suite runs on JAX's CPU backend with 8 virtual devices (the sharding
# tests build meshes on them).  A JAX_PLATFORMS set by the caller is kept:
# the tests marked `gpu` run on the card with JAX_PLATFORMS=cuda,cpu
# (README).  Both must be set before jax initializes a backend.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU; skips without one")
    config.addinivalue_line("markers", "slow: long-running; excluded from the tier-1 run")
    import jax

    if os.environ["JAX_PLATFORMS"] == "cpu" and len(jax.devices()) != 8:
        warnings.warn(
            f"expected 8 virtual CPU devices, got {len(jax.devices())}: "
            "sharding tests may fail (XLA_FLAGS set too late?)"
        )

import subprocess
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
REFBUILD = REPO / ".refbuild"
WORK = Path(__file__).resolve().parent / "_work"


def have_reference() -> bool:
    return (REFBUILD / "bin" / "kart").exists() and (REFBUILD / "bin" / "bwt_index").exists()


needs_reference = pytest.mark.skipif(
    not have_reference(), reason="reference oracle binaries not built (.refbuild/bin)"
)


def make_genome(rng: np.random.Generator, chrom_lens, n_runs=0) -> str:
    """Random genome FASTA text with optional N runs."""
    out = []
    for i, L in enumerate(chrom_lens):
        seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=L)
        for _ in range(n_runs):
            p = rng.integers(0, max(1, L - 20))
            seq[p : p + int(rng.integers(1, 15))] = ord("N")
        lines = [f">chr{i + 1} test sequence {i + 1}"]
        s = seq.tobytes().decode()
        lines += [s[j : j + 70] for j in range(0, len(s), 70)]
        out.append("\n".join(lines))
    return "\n".join(out) + "\n"


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test when JAX has none (decided
    here, at run time, never while test modules are imported)."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip(f"needs a GPU; JAX's backends here: {jax.default_backend()}")
    return devs[0]


@pytest.fixture(scope="session")
def workdir():
    WORK.mkdir(parents=True, exist_ok=True)
    return WORK


@pytest.fixture(scope="session")
def small_genome(workdir):
    """A 100kb 2-chromosome genome with N holes, indexed by both the
    reference indexer (if available) and ours."""
    rng = np.random.default_rng(1234)
    fa = workdir / "small.fa"
    fa.write_text(make_genome(rng, [60000, 40000], n_runs=3))
    return fa


def run_reference_indexer(fa: Path, prefix: Path):
    subprocess.run(
        [str(REFBUILD / "bin" / "bwt_index"), str(fa), str(prefix)],
        check=True,
        capture_output=True,
    )


def run_reference_kart(args: list[str]):
    return subprocess.run(
        [str(REFBUILD / "bin" / "kart")] + args, check=True, capture_output=True
    )
