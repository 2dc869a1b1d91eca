"""The golden index of tests/golden/ref.fa for the port's tests (not a
test module).

Each `tests/test_torch_*.py` that needs the golden index imports the two
fixtures below, `golden_index_dir` and `golden_oracle_index`, which
override conftest.py's fixtures of the same names in that module (both
names, since conftest's `golden_oracle_index` would resolve
`golden_index_dir` from the requesting module). conftest's cache under
/tmp/desamba_tpu_test_cache is keyed by the FASTA's mtime and rebuilt in
place by every worker that finds it stale, so a fresh checkout's workers
read it half written; the port's tests take their own copy instead:

- built with the JAX package's builder (build_index, then
  save_ref_format), as conftest builds its own;
- under the system's temporary directory (`tempfile.gettempdir()`, so
  TMPDIR moves it), in a directory keyed by the SHA-256 of ref.fa's
  content;
- by one process at a time: the builder holds an exclusive `fcntl.flock`
  on a lock file beside the index, writes into a fresh temporary
  directory next to it, and `os.rename`s that into place, so a reader
  finds the whole index or none. The others wait on the lock and then
  find it built.

No port test reads nodes.dmp or names.dmp from the index directory, so
the index holds the builder's files only. An index takes ~770 MB of
disk.
"""
import contextlib
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import tempfile

import pytest

GOLD_FA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "ref.fa")


def default_parent() -> str:
    return os.path.join(tempfile.gettempdir(), "desamba_tpu_torch_golden")


def content_key(fa: str = GOLD_FA) -> str:
    with open(fa, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:20]


@contextlib.contextmanager
def locked(path: str):
    """An exclusive flock on path (created if missing) for the block."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def golden_index(parent: str | None = None, fa: str = GOLD_FA) -> str:
    """The directory of fa's index in the C reference's format under
    parent (default_parent()), built there once if it is missing."""
    from desamba_tpu.index.build import build_index
    from desamba_tpu.index.format_ref import save_ref_format

    parent = parent or default_parent()
    os.makedirs(parent, exist_ok=True)
    name = f"idx-{content_key(fa)}"
    final = os.path.join(parent, name)
    if os.path.isdir(final):
        return final
    with locked(os.path.join(parent, name + ".lock")):
        if os.path.isdir(final):
            return final
        # what a builder killed mid-build left; only a lock holder builds
        for old in glob.glob(os.path.join(parent, f".{name}-build-*")):
            shutil.rmtree(old, ignore_errors=True)
        tmp = tempfile.mkdtemp(prefix=f".{name}-build-", dir=parent)
        try:
            save_ref_format(build_index(fa), tmp)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    return final


@functools.lru_cache(maxsize=None)
def _oracle_index(path: str):
    from desamba_tpu.index.format_ref import RefFormatIndex
    from desamba_tpu.oracle.classify import OracleIndex

    return OracleIndex(RefFormatIndex(path))


@pytest.fixture(scope="session")
def golden_index_dir():
    """The golden index's directory (golden_index())."""
    return golden_index()


@pytest.fixture(scope="session")
def golden_oracle_index(golden_index_dir):
    """The JAX package's OracleIndex of the golden index, one a process."""
    return _oracle_index(golden_index_dir)
