"""Two deploys of one static site in one tar archive, as a release or
backup job hands it to the brotli CLI: `v1/` holds the older build's
files and `v2/` the newer one's, each member a file of the repository's
public data (benchmark/data, with its licences in NOTICE.txt there).
The traffic's `members` are [name, older file, newer file]; a file the
two deploys share is named twice.

The archive is what Python's tarfile writes in the POSIX ustar format:
a directory entry a deploy, every member with mode 0644, owner 0 and
mtime 0 and no owner names, two zero blocks at the end, padded to
whole 10,240-byte records. So its bytes depend on the members' order
alone, and its size on none of it.

The seed rotates the members of both directories, the orders a tar
without --sort may take from a directory: document j of the pool made
from the run's seed s lists them rotated by s + j * len(members) //
pool (at a pool of 2, the second document starts half way round from
the first). The sizes never change, so neither does the archive's.
"""

import io
import pathlib
import tarfile

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


def _entry(name, size, directory=False):
    info = tarfile.TarInfo(name)
    info.size = 0 if directory else size
    info.type = tarfile.DIRTYPE if directory else tarfile.REGTYPE
    info.mode = 0o755 if directory else 0o644
    info.mtime = 0
    info.uid = info.gid = 0
    info.uname = info.gname = ""
    return info


def archive(members, rotation: int) -> bytes:
    """The ustar archive of both deploys, each directory's members
    rotated by `rotation`."""
    k = rotation % len(members)
    order = list(members[k:]) + list(members[:k])
    out = io.BytesIO()
    with tarfile.open(fileobj=out, mode="w", format=tarfile.USTAR_FORMAT) \
            as tar:
        for deploy, col in (("v1", 1), ("v2", 2)):
            tar.addfile(_entry(deploy + "/", 0, directory=True))
            for m in order:
                data = (DATA / m[col]).read_bytes()
                tar.addfile(_entry(f"{deploy}/{m[0]}", len(data)),
                            io.BytesIO(data))
    return out.getvalue()


def documents(seed: int, pool: int, members) -> list:
    return [archive(members, seed + j * len(members) // pool)
            for j in range(pool)]
