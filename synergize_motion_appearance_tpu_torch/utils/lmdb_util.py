"""Build an lmdb of PNG-encoded images (the reference's
utils/lmdb_util.py:9-196; the port's copy of the JAX package's).

Needs the optional lmdb package, and OpenCV to read and encode the
images; each function raises a RuntimeError that names the one that is
absent. The native frame cache (data/native_loader.py) needs neither.
"""
from __future__ import annotations

from os import path as osp
from typing import List, Optional, Tuple

from .misc import require


def _new_lmdb(lmdb_path: str, map_size: int):
    lmdb = require("lmdb", "writing an lmdb")
    if not lmdb_path.endswith(".lmdb"):
        raise ValueError("lmdb_path must end with '.lmdb'")
    if osp.exists(lmdb_path):
        raise FileExistsError(f"{lmdb_path} already exists")
    return lmdb.open(lmdb_path, map_size=map_size)


def make_lmdb_from_imgs(data_path: str, lmdb_path: str,
                        img_path_list: List[str], keys: List[str],
                        batch: int = 5000, compress_level: int = 1,
                        map_size: Optional[int] = None) -> None:
    """An lmdb at ``lmdb_path`` whose entry ``key`` holds the PNG bytes of
    ``data_path/<path>``, with the reference's meta_info.txt beside it
    ("<key>.png (h,w,c) <compress_level>" a line); a commit every
    ``batch`` images. Without ``map_size``, ten times the first image's
    PNG bytes per image."""
    cv2 = require("cv2", "make_lmdb_from_imgs")
    if len(img_path_list) != len(keys):
        raise ValueError(f"{len(img_path_list)} images for {len(keys)} "
                         f"keys")
    png = [cv2.IMWRITE_PNG_COMPRESSION, compress_level]

    def encoded(path):
        img = cv2.imread(osp.join(data_path, path), cv2.IMREAD_UNCHANGED)
        return img, cv2.imencode(".png", img, png)[1]

    if map_size is None:
        map_size = len(encoded(img_path_list[0])[1]) * len(img_path_list) * 10
    env = _new_lmdb(lmdb_path, map_size)
    txn = env.begin(write=True)
    with open(osp.join(lmdb_path, "meta_info.txt"), "w") as txt_file:
        for idx, (path, key) in enumerate(zip(img_path_list, keys)):
            img, img_byte = encoded(path)
            h, w = img.shape[:2]
            c = img.shape[2] if img.ndim == 3 else 1
            txn.put(key.encode("ascii"), img_byte.tobytes())
            txt_file.write(f"{key}.png ({h},{w},{c}) {compress_level}\n")
            if idx % batch == 0:
                txn.commit()
                txn = env.begin(write=True)
        txn.commit()
    env.close()


class LmdbMaker:
    """Writes encoded images to a new lmdb one at a time, committing every
    ``batch`` (lmdb_util.py:156-196)."""

    def __init__(self, lmdb_path: str, map_size: int = 1024 ** 4,
                 batch: int = 5000, compress_level: int = 1):
        self.env = _new_lmdb(lmdb_path, map_size)
        self.txn = self.env.begin(write=True)
        self.txt_file = open(osp.join(lmdb_path, "meta_info.txt"), "w")
        self.batch = batch
        self.compress_level = compress_level
        self.counter = 0

    def put(self, img_byte: bytes, key: str,
            img_shape: Tuple[int, int, int]) -> None:
        self.counter += 1
        self.txn.put(key.encode("ascii"), img_byte)
        h, w, c = img_shape
        self.txt_file.write(f"{key}.png ({h},{w},{c}) "
                            f"{self.compress_level}\n")
        if self.counter % self.batch == 0:
            self.txn.commit()
            self.txn = self.env.begin(write=True)

    def close(self) -> None:
        self.txn.commit()
        self.env.close()
        self.txt_file.close()
