"""fsync and atomic-publish helpers (port of the commit protocol in
``repro/checkpoint/manager.py``).

An artifact is written into ``<dir>.tmp`` with every file fsynced, then
``commit_dir`` renames it into place and fsyncs the parent, so a crash
leaves either the old artifact or the new one, never a torn directory.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any


def fsync_file(path: str) -> None:
    """fsync an already-written file so it survives a crash after rename."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """fsync a directory so its entries (a rename included) are durable.

    Best-effort on platforms where directories can't be opened/fsynced.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_json_fsync(path: str, obj: Any) -> None:
    """Write JSON and fsync the file before returning."""
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


def commit_dir(tmp: str, path: str) -> None:
    """Atomically publish ``tmp`` as ``path`` (rename + parent-dir fsync).

    Callers must have fsynced every file inside ``tmp`` first: the rename
    is the commit point, so anything not durable before it can be lost
    while the directory still looks committed.

    Replacing an existing committed ``path`` renames it aside first and
    deletes it only after the new directory is in place: at no instant is
    there no committed artifact on disk (a crash leaves either the old or
    the new one, never a bare ``.tmp``).
    """
    old = path + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))
    if os.path.exists(old):
        shutil.rmtree(old)
