"""Carry a cluster's files across to the port.

``cluster_from_files`` takes files as plain Python values — ``path ->
(file bytes, xattrs, stripe unit)`` — and returns a port ``CephFS``
holding the same files, so the port scans exactly the bytes another
writer produced.  Fill the dict from any cluster through its public
``listdir`` / ``stat`` / ``read_file`` API.
"""

from __future__ import annotations

from repro_torch.core import make_cluster
from repro_torch.storage.cephfs import CephFS


def cluster_from_files(files: dict[str, tuple[bytes, dict, int]],
                       num_osds: int = 8) -> CephFS:
    fs = make_cluster(num_osds)
    for path in sorted(files):
        data, xattrs, stripe_unit = files[path]
        fs.write_file(path, bytes(data), stripe_unit=int(stripe_unit),
                      xattrs=dict(xattrs))
    return fs
