"""The port's file-system shim (``paddle_tpu_torch/io/fs.py``) against the
JAX package's: the same LocalFS calls on two fresh trees leave the same
trees and answer the same, the path prefix picks the same client, and
every HDFS entry point raises the port's ``errors.Unavailable`` where no
``hadoop`` binary is found (a fake ``hadoop`` on the path answers the
calls it is asked)."""
import torch_threads  # noqa: F401 (one torch thread a worker)
import os
import stat

import pytest

from paddle_tpu.io import fs as jfs

from paddle_tpu_torch import errors
from paddle_tpu_torch.io import fs as tfs


def _drive(mod, root):
    """A script of LocalFS calls under ``root``; returns every answer."""
    fs = mod.LocalFS()
    d = os.path.join(root, "a", "b")
    out = [fs.ls_dir(os.path.join(root, "missing"))]
    fs.mkdirs(d)
    out.append(fs.is_dir(d))
    fs.touch(os.path.join(d, "f.txt"))
    fs.touch(os.path.join(root, "a", "top.txt"))
    out += [fs.is_file(os.path.join(d, "f.txt")),
            fs.ls_dir(os.path.join(root, "a"))]
    fs.mv(os.path.join(d, "f.txt"), os.path.join(d, "g.txt"))
    out += [fs.is_exist(os.path.join(d, "g.txt")),
            fs.is_exist(os.path.join(d, "f.txt"))]
    fs.delete(os.path.join(root, "a", "top.txt"))
    out.append(fs.ls_dir(os.path.join(root, "a")))
    fs.delete(os.path.join(root, "a"))
    out.append(fs.is_exist(os.path.join(root, "a")))
    return out


def test_localfs_answers_as_the_reference(tmp_path):
    want = _drive(jfs, str(tmp_path / "jax"))
    got = _drive(tfs, str(tmp_path / "port"))
    assert got == want
    assert got[3] == (["b"], ["top.txt"])


@pytest.mark.parametrize("path,kind", [("/tmp/x", "LocalFS"),
                                       ("hdfs://ns/x", "HDFSClient"),
                                       ("afs://ns/x", "HDFSClient")])
def test_fs_for_path_picks_the_same_client(path, kind):
    assert type(tfs.fs_for_path(path)).__name__ == kind
    assert type(jfs.fs_for_path(path)).__name__ == kind


@pytest.mark.parametrize("call", ["ls_dir", "mkdirs", "delete", "touch",
                                  "is_exist", "upload", "download", "mv"])
def test_hdfs_without_hadoop_raises_unavailable(call, tmp_path):
    client = tfs.HDFSClient(hadoop_home=str(tmp_path / "no_hadoop"))
    args = {"upload": ("local", "remote"), "download": ("remote", "local"),
            "mv": ("a", "b")}.get(call, ("hdfs://x/y",))
    with pytest.raises(errors.Unavailable, match="hadoop"):
        getattr(client, call)(*args)


def test_hdfs_shells_out_to_hadoop_fs(tmp_path):
    """A fake `hadoop` prints a listing and records its arguments."""
    home = tmp_path / "hadoop"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "args.txt"
    script = home / "bin" / "hadoop"
    script.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "case \"$*\" in *' -ls '*)\n"
        "  echo 'drwxr-xr-x - u g 0 2024-01-01 00:00 /d/sub'\n"
        "  echo '-rw-r--r-- 1 u g 9 2024-01-01 00:00 /d/file.txt';;\n"
        "esac\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    for mod in (tfs, jfs):
        client = mod.HDFSClient(hadoop_home=str(home),
                                configs={"fs.default.name": "hdfs://ns"})
        assert client.ls_dir("/d") == (["sub"], ["file.txt"])
        client.mkdirs("/d/new")
    lines = log.read_text().splitlines()
    assert lines[:2] == lines[2:]  # both clients ran the same commands
    assert lines[0] == "fs -D fs.default.name=hdfs://ns -ls /d"
