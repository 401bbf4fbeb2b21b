"""Build the native host-runtime library: python -m dbot_ros_tpu.native.build"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile


def build(verbose: bool = True) -> str:
    """Compile ``host_runtime.cpp`` next to itself; returns the path.

    Writes to a temporary name and renames, so processes that build at
    the same time (test workers) never load a half-written library.
    """
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "host_runtime.cpp")
    out = os.path.join(here, "libdbot_host.so")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=here)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-Wall", src,
           "-o", tmp]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    sys.exit(0)
