"""Filesystem shim: LocalFS + HDFS client.

Port of ``paddle_tpu/io/fs.py``, plain Python copied with the port's
typed errors: the C++ POSIX/HDFS shim of the reference's
``framework/io/{fs.cc,shell.cc}`` (which the dataset loaders and
auto-checkpoint use) and its Python ``incubate/fleet/utils/fs.py``
(LocalFS / HDFSClient with ls_dir, is_exist, upload, download, mkdirs,
delete, mv, touch). HDFS operations shell out to `hadoop fs` like the
reference's shell-pipe implementation; every HDFS entry point raises
errors.Unavailable when no hadoop binary is installed, so jobs degrade
loudly rather than silently writing local paths."""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Tuple

from ..framework.errors import errors


class FS:
    """Abstract surface (reference fs.py FS)."""

    def ls_dir(self, path) -> Tuple[List[str], List[str]]:
        raise NotImplementedError

    def is_exist(self, path) -> bool:
        raise NotImplementedError

    def is_dir(self, path) -> bool:
        raise NotImplementedError

    def is_file(self, path) -> bool:
        raise NotImplementedError

    def mkdirs(self, path) -> None:
        raise NotImplementedError

    def delete(self, path) -> None:
        raise NotImplementedError

    def mv(self, src, dst) -> None:
        raise NotImplementedError

    def touch(self, path) -> None:
        raise NotImplementedError


class LocalFS(FS):
    """POSIX shim (reference fs.cc localfs_* functions)."""

    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, name))
             else files).append(name)
        return dirs, files

    def is_exist(self, path):
        return os.path.exists(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def mv(self, src, dst):
        shutil.move(src, dst)

    def touch(self, path):
        open(path, "a").close()


class HDFSClient(FS):
    """`hadoop fs` subprocess client (reference fs.cc hdfs_* shell
    pipes + incubate fleet utils HDFSClient)."""

    def __init__(self, hadoop_home: str = "", configs: dict | None = None):
        self._hadoop = (os.path.join(hadoop_home, "bin", "hadoop")
                        if hadoop_home else "hadoop")
        self._configs = configs or {}

    def _available(self) -> bool:
        return shutil.which(self._hadoop) is not None

    def _run(self, *args) -> str:
        if not self._available():
            raise errors.Unavailable(
                f"hadoop binary {self._hadoop!r} not found; HDFS paths "
                f"need a hadoop client installed")
        cfg = []
        for k, v in self._configs.items():
            cfg += ["-D", f"{k}={v}"]
        proc = subprocess.run(
            [self._hadoop, "fs", *cfg, *args],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise errors.External(
                f"hadoop fs {' '.join(args)}: {proc.stderr.strip()}")
        return proc.stdout

    def ls_dir(self, path):
        out = self._run("-ls", path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, path):
        try:
            self._run("-test", "-e", path)
            return True
        except errors.External:
            return False

    def is_dir(self, path):
        try:
            self._run("-test", "-d", path)
            return True
        except errors.External:
            return False

    def is_file(self, path):
        return self.is_exist(path) and not self.is_dir(path)

    def mkdirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        self._run("-rm", "-r", "-f", path)

    def mv(self, src, dst):
        self._run("-mv", src, dst)

    def touch(self, path):
        self._run("-touchz", path)

    def upload(self, local, remote):
        self._run("-put", "-f", local, remote)

    def download(self, remote, local):
        self._run("-get", remote, local)


def fs_for_path(path: str) -> FS:
    """hdfs:// or afs:// -> HDFSClient, everything else -> LocalFS (the
    reference dispatches fs.cc fs_select by prefix the same way)."""
    if path.startswith(("hdfs://", "afs://")):
        return HDFSClient()
    return LocalFS()
