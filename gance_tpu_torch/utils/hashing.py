"""
Chunked file hashing for provenance fields (a copy of gance_tpu/utils/hashing.py):
the MD5 of a file read in chunks, as projection-file attrs and synthesis-file
JSON sidecars record it.
"""

import hashlib
from pathlib import Path

_CHUNK_SIZE = 4 * 1024 * 1024


def hash_file(path: Path) -> str:
    """Chunked MD5 hex digest of the file at `path`."""
    digest = hashlib.md5()
    with open(str(path), "rb") as infile:
        while True:
            chunk = infile.read(_CHUNK_SIZE)
            if not chunk:
                break
            digest.update(chunk)
    return digest.hexdigest()
