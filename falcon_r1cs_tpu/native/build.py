"""Build-on-first-use for the repository's C and CUDA sources.

Each shared library is keyed on a hash of everything that determines its
machine code: every source and header it is built from, the compiler
commands, and the host CPU (``-march=native`` code built on one host can
die with an illegal instruction on another).  Libraries land in the
gitignored ``_build`` directory beside the sources, one file per key, so
a checkout that moves between hosts, or whose headers change, never
loads a stale library.  Concurrent builds (test workers) each write a
private temporary file and rename it into place.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def host_key() -> str:
    """The host facts a native build depends on: architecture, CPU model
    and CPU feature flags."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        lines = []
    model = next((ln for ln in lines if ln.startswith("model name")), "")
    flags = next((ln for ln in lines if ln.startswith("flags")), "")
    return "\n".join((platform.machine(), model, flags))


def build_key(inputs, commands) -> str:
    """Hex digest over the input files' names and bytes, the candidate
    compiler commands and the host key."""
    h = hashlib.sha256()
    for path in inputs:
        path = Path(path)
        h.update(path.name.encode() + b"\0")
        h.update(path.read_bytes())
    for cmd in commands:
        h.update("\0".join(cmd).encode() + b"\n")
    h.update(host_key().encode())
    return h.hexdigest()[:20]


def build_library(name: str, inputs, commands) -> Path:
    """Path of the shared library `name` built from `inputs`.

    `commands` lists alternative compiler invocations, each without its
    ``-o`` output; the first that succeeds is kept.  Raises
    RuntimeError with the compilers' messages when none does."""
    key = build_key(inputs, commands)
    out = BUILD_DIR / f"{name}-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    errors = []
    for cmd in commands:
        try:
            subprocess.run(
                [*cmd, "-o", str(tmp)], check=True, capture_output=True
            )
        except FileNotFoundError as e:
            errors.append(f"{cmd[0]}: {e}")
            continue
        except subprocess.CalledProcessError as e:
            errors.append(e.stderr.decode(errors="replace")[-4000:])
            continue
        os.replace(tmp, out)
        return out
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"building {name} failed:\n" + "\n".join(errors))
