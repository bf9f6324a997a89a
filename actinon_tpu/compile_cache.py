"""Persistent XLA compilation cache.

Composite-heavy scenes (hanging_lamp: many CSG composites) produce large
HLO modules whose first compile is expensive.  The persistent cache
makes every compile after the first a lookup across processes.

The directory is `JAX_COMPILATION_CACHE_DIR` when that is set (JAX reads
it itself; nothing here overrides it), else the fixed `.jax_cache/` at
the root of the checkout.  The path is part of what makes a later
process find an entry, so it never depends on the host.

Call enable() from entry points (CLI, bench, chip smoke, tests,
golden_gen).  Set ACTINON_NO_COMPILE_CACHE=1 to opt out (e.g. when
measuring cold-compile time itself).
"""

import os

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses off the CPU."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_DIR


def _patch_atomic_writes() -> None:
    """Make jax's persistent-cache writes atomic (temp + rename).

    jax's LRUCache.put writes entries with a plain write_bytes; a
    process killed mid-write leaves a TRUNCATED entry, and XLA's
    executable deserializer segfaults on it (observed as a reproducible
    SIGSEGV inside compilation_cache.get_executable_and_time until the
    entry was deleted).  os.replace on the same filesystem is atomic, so
    readers only ever see complete entries."""
    try:
        from jax._src.lru_cache import LRUCache
    except ImportError:
        return
    if getattr(LRUCache, "_actinon_atomic", False):
        return
    orig_put = LRUCache.put

    def put(self, key, val):
        import pathlib
        write_bytes = pathlib.Path.write_bytes

        def atomic_write(path, data):
            tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
            write_bytes(tmp, data)
            os.replace(tmp, path)
            return len(data)

        pathlib.Path.write_bytes = atomic_write
        try:
            return orig_put(self, key, val)
        finally:
            pathlib.Path.write_bytes = write_bytes

    LRUCache.put = put
    LRUCache._actinon_atomic = True


def enable() -> None:
    import jax

    # XLA:CPU AOT executables do not reliably survive the persistent
    # cache on this jaxlib: deserialization warns about pseudo machine
    # features ('+prefer-no-scatter ... not supported on the host
    # machine ... could lead to execution errors such as SIGILL') even
    # for entries written on the SAME host, and pytest runs segfaulted
    # inside compilation_cache.get_executable_and_time with fully intact
    # entries.  CPU compiles are a bounded cost; cache only the
    # accelerator's compiles.
    if os.environ.get("ACTINON_NO_COMPILE_CACHE") \
            or jax.default_backend() == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return

    _patch_atomic_writes()
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    # cache everything that took XLA real effort; tiny programs recompile
    # faster than they (de)serialize
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
