"""Images read from zip archives, ``archive.zip@/inner/path`` (reference:
lib/utils/zipreader.py:23-46).

Counterpart of buctd_tpu/utils/zipreader.py (the port's own copy).  Both
loaders read ``DATASET.DATA_FORMAT zip`` through ``imread``
(data/joints_dataset.py::imread_rgb).  Open archives are kept in a cache
owned by a ``ZipCache``; the module's one instance serves ``imread``.
"""

from __future__ import annotations

import os
import threading
import zipfile

import numpy as np


def split_zip_path(path: str):
    """'a.zip@/x/y.jpg' -> ('a.zip', 'x/y.jpg'): the reference skips the
    character after '@' too."""
    pos = path.index("@")
    return path[:pos], path[pos + 2:]


class ZipCache:
    """Open ``zipfile.ZipFile`` handles by archive path.  The loaders read
    from a thread pool: a ZipFile is not safe for concurrent reads, so each
    archive's reads hold its own lock."""

    def __init__(self):
        self._files: dict = {}
        self._lock = threading.Lock()

    def read(self, path_zip: str, name: str) -> bytes:
        with self._lock:
            entry = self._files.get(path_zip)
            if entry is None:
                entry = self._files[path_zip] = (zipfile.ZipFile(path_zip, "r"),
                                                 threading.Lock())
        zf, lock = entry
        with lock:
            return zf.read(name)


_CACHE = ZipCache()


def imread(filename: str, flags=None):
    """cv2.imdecode of one member of a zip archive (``cv2.IMREAD_COLOR`` by
    default); raises FileNotFoundError where the archive is missing."""
    import cv2

    if flags is None:
        flags = cv2.IMREAD_COLOR
    path_zip, path_img = split_zip_path(filename)
    if not os.path.isfile(path_zip):
        raise FileNotFoundError(f"zip file '{path_zip}' is not found")
    data = _CACHE.read(path_zip, path_img)
    return cv2.imdecode(np.frombuffer(data, np.uint8), flags)
