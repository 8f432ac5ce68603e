"""Builds the port's native sources into shared libraries at first use.

Every library goes to ``diffudf_tpu_torch/_build/`` (ignored by git) under a
name that carries a hash of its sources and command line, so an edited
source is rebuilt and a library built elsewhere is never loaded.  The build
writes a temporary file and renames it, so processes that build at the same
time each end with a whole library.  The compiler's messages (for ``nvcc``,
the ``-Xptxas -v`` register report) are kept beside the library as
``<name>-<hash>.log``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def library_path(name: str, cmd: list, sources: list) -> str:
    """Where the library built by ``cmd`` from ``sources`` lives."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in sources:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_shared(name: str, cmd: list, sources: list) -> str:
    """Compile ``sources[0]`` (``sources[1:]`` are headers it includes) with
    ``cmd + ['-o', out, sources[0]]`` unless already built; -> library path.

    Raises RuntimeError with the compiler's output when the build fails."""
    out = library_path(name, cmd, sources)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    full = list(cmd) + ["-o", tmp, sources[0]]
    try:
        proc = subprocess.run(full, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"building {name}: compiler not found ({exc})") from exc
    if proc.returncode:
        raise RuntimeError(
            f"building {name} failed ({' '.join(full)}):\n{proc.stdout}{proc.stderr}"
        )
    with open(out[:-3] + ".log", "w") as fh:
        fh.write(" ".join(full) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out
