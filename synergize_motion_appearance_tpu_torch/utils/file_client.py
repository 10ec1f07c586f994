"""Storage backends that read a sample's bytes (the reference's
utils/file_client.py:5-167; the port's copy of the JAX package's).

``disk`` always works. ``lmdb`` needs the lmdb package, and raises a
RuntimeError that names it when that is absent. ``memcached`` raises
ImportError, as in the JAX package.
"""
from __future__ import annotations

from .misc import require


class BaseStorageBackend:
    def get(self, filepath: str) -> bytes:
        raise NotImplementedError

    def get_text(self, filepath: str) -> str:
        raise NotImplementedError


class HardDiskBackend(BaseStorageBackend):
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()

    def get_text(self, filepath: str) -> str:
        with open(filepath, "r") as f:
            return f.read()


class LmdbBackend(BaseStorageBackend):
    """One read-only lmdb environment per database path, each under its
    client key (file_client.py:74+)."""

    def __init__(self, db_paths, client_keys="default", readonly=True,
                 lock=False, readahead=False, **kwargs):
        lmdb = require("lmdb", "the lmdb io backend (use 'disk' or the "
                               "native frame cache)")
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        if len(client_keys) != len(db_paths):
            raise ValueError(f"{len(client_keys)} client keys for "
                             f"{len(db_paths)} lmdb paths")
        self._client = {
            k: lmdb.open(p, readonly=readonly, lock=lock,
                         readahead=readahead, **kwargs)
            for k, p in zip(client_keys, db_paths)}

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        with self._client[client_key].begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))


class MemcachedBackend(BaseStorageBackend):
    def __init__(self, server_list_cfg, client_cfg, sys_path=None):
        # ImportError, as the JAX package's backend raises (its
        # utils/file_client.py:58-63), so that a caller catching it catches
        # this one too
        raise ImportError("the memcached io backend is not available (the "
                          "reference's mc client is not ported); use "
                          "'disk'")


class FileClient:
    _backends = {
        "disk": HardDiskBackend,
        "lmdb": LmdbBackend,
        "memcached": MemcachedBackend,
    }

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(f"Backend {backend} not supported. "
                             f"Available: {list(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        if self.backend == "lmdb":
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath: str) -> str:
        return self.client.get_text(filepath)
