"""On-disk artifact cache for packed genomes and site tables.

SURVEY.md §5: the reference recomputes everything per run in temp dirs that
are deleted on exit (targets.py:564, BowtieRunner.py:52-53 — including the
Bowtie FM-index build every single invocation). Here the two host-side scan
artifacts persist across processes, keyed by CONTENT digest (blake2b-128 of
the contig codes) plus the structural parameters, so a second CLI
invocation on the same genome skips host prep entirely:

- ``sites-<key>.npz`` — ``ops.prep.enumerate_sites`` output (positions,
  strands, window codes) for one (contig, L, pam, direction); the dominant
  host cost of the site-compacted engine at large-genome scale.
- ``scan-<key>.npz``  — the 2-bit-packed device scan array + N-exception
  list for one (contig, L-halo) — the ship payload of the dense engine.

Layout: ``$BARCODER_TPU_ARTIFACTS`` (default
``~/.cache/barcoder_tpu/artifacts``), one ``.npz`` per artifact, written
atomically (tmp + rename) so concurrent processes can share the directory.
Set ``BARCODER_TPU_NO_ARTIFACTS=1`` to disable. Content-digest keys make
invalidation automatic: editing the genome changes the key. Complements
(does not replace) the in-process device LRUs in ops/pallas_scan.py, which
hold the post-ship DEVICE arrays and die with the process.
"""

from __future__ import annotations

import os

import numpy as np

_ENV_DIR = "BARCODER_TPU_ARTIFACTS"
_ENV_OFF = "BARCODER_TPU_NO_ARTIFACTS"

# observability: targets --profile and tests read these
stats = {"hits": 0, "misses": 0, "stores": 0}


def cache_dir() -> str | None:
    if os.environ.get(_ENV_OFF):
        return None
    d = os.environ.get(_ENV_DIR) or os.path.join(
        os.path.expanduser("~"), ".cache", "barcoder_tpu", "artifacts"
    )
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        return None
    return d


def load(kind: str, key: str) -> dict[str, np.ndarray] | None:
    """Fetch an artifact; None on miss/corruption/disabled (never raises)."""
    d = cache_dir()
    if d is None:
        return None
    path = os.path.join(d, f"{kind}-{key}.npz")
    try:
        with np.load(path, allow_pickle=False) as z:
            out = {k: z[k][...] for k in z.files}
        stats["hits"] += 1
        return out
    except Exception:
        stats["misses"] += 1
        return None


def exists(kind: str, key: str) -> bool:
    """Cheap presence probe (no load): does this artifact sit on disk?"""
    d = cache_dir()
    if d is None:
        return False
    return os.path.exists(os.path.join(d, f"{kind}-{key}.npz"))


def store(kind: str, key: str, **arrays: np.ndarray) -> None:
    """Persist an artifact atomically; best-effort (never raises)."""
    d = cache_dir()
    if d is None:
        return
    path = os.path.join(d, f"{kind}-{key}.npz")
    # pid + thread id: two THREADS of one API process storing the same key
    # concurrently would interleave on a pid-only temp name and publish a
    # corrupt archive via os.replace (r5 review)
    import threading

    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
        stats["stores"] += 1
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
