"""An inter-process lock on a file, for the builds of the native library
and the CUDA kernels: several processes that start on a fresh checkout
(torchrun, the multi-process encoder's workers) must not compile into
the same library at once, nor load one that another is still writing.
"""

import contextlib
import fcntl


@contextlib.contextmanager
def locked(path):
    """Hold an exclusive `flock` on `path` (created if missing) for the
    body; other processes taking it wait. The kernel drops the lock when
    the process exits, however it exits, so no stale lock is left."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
