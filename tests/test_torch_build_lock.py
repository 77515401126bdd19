"""The kernel build of the port (greptimedb_tpu_torch/ops/_build.py) when
several processes start on one fresh checkout at once, as two frontends
do: the objects have one shared path each, so the build runs under a
lock and the second process loads what the first one built.

nvcc is replaced by a shell script that logs its arguments, sleeps, and
writes its output file, so the test runs on a machine without the CUDA
toolkit.
"""

import os
import stat
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = """#!/bin/sh
echo "$*" >> {log}
sleep 1
out=""
prev=""
for a in "$@"; do
    if [ "$prev" = "-o" ]; then out="$a"; fi
    prev="$a"
done
printf 'fake kernel object' > "$out"
"""

BUILD_SCRIPT = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    from greptimedb_tpu_torch.ops import _build
    _build.BUILD_DIR = {build_dir!r}
    _build.LIB_PATH = os.path.join({build_dir!r}, "libsegment_kernels.so")
    _build._nvcc = lambda: {nvcc!r}
    print(_build.build(), _build.build_seconds > 0, flush=True)
""")


def test_two_processes_build_once_and_share_the_library(tmp_path):
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    build_dir = str(tmp_path / "_build")
    script = BUILD_SCRIPT.format(repo=REPO, build_dir=build_dir,
                                 nvcc=str(nvcc))
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.split())
    lib = os.path.join(build_dir, "libsegment_kernels.so")
    assert [o[0] for o in outs] == [lib, lib]
    # one process compiled and linked; the other waited and reused it
    assert sorted(o[1] for o in outs) == ["False", "True"]
    calls = log.read_text().splitlines()
    sources = [f for f in os.listdir(os.path.join(
        REPO, "greptimedb_tpu_torch", "csrc")) if f.endswith(".cu")]
    assert sum(" -c " in c for c in calls) == len(sources)
    assert sum(" -shared " in c for c in calls) == 1
    with open(lib, "rb") as f:
        assert f.read() == b"fake kernel object"
    assert not [f for f in os.listdir(build_dir) if ".tmp" in f]
