"""kart-tpu: a JAX NGS read aligner with the capabilities of Kart.

Device seeding runs through JAX/XLA; the post-seeding pipeline is native
C++.  See SURVEY.md for the layer map of the reference aligner this
reimplements.
"""

__version__ = "0.1.0"

import os as _os

# the compile cache's fixed home inside the checkout (gitignored): a cache
# directory that moves between runs never hits
REPO_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir(environ=_os.environ) -> str | None:
    """The directory this package points JAX's persistent compilation cache
    at, or None when JAX_COMPILATION_CACHE_DIR is set (JAX reads that
    variable itself and the package then sets nothing)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


def _setup_jax_cache():
    """Persistent XLA compilation cache so repeated runs skip recompiling
    the seeding kernels."""
    cache_dir = compilation_cache_dir()
    if cache_dir is None:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", cache_dir)


_setup_jax_cache()
