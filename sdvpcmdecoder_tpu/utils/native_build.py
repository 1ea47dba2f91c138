"""Build the native cores (native/*.cpp) from source on the host that
loads them.

A library is rebuilt whenever it is missing or older than its source.
A failed build raises BuildError carrying the compiler's message; it
never falls back to an existing binary, since one built elsewhere (or
from an older source) can crash with SIGILL or disagree with the
Python side's symbol table.
"""
from __future__ import annotations

import os
import subprocess
from pathlib import Path


class BuildError(RuntimeError):
    """The compiler failed (or is missing) for every flag set tried."""


def build(src: Path, lib_name: str, flag_sets, libs=()) -> Path:
    """Return the path of an up-to-date shared library built from `src`.

    flag_sets: compiler flag lists tried in order until one builds.
    The output goes to a per-process temporary name and is renamed into
    place, so concurrent processes never load a half-written file."""
    src = Path(src)
    lib = src.with_name(lib_name)
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    tmp = lib.with_name(f".{lib.stem}.{os.getpid()}.so")
    errors = []
    for flags in flag_sets:
        try:
            r = subprocess.run(
                ["g++", *flags, "-shared", "-fPIC", "-o", str(tmp),
                 str(src), *libs], capture_output=True, text=True)
        except OSError as e:           # no compiler on this host
            raise BuildError(f"cannot run g++ for {src.name}: {e}") from e
        if r.returncode == 0:
            os.replace(tmp, lib)
            return lib
        errors.append(f"g++ {' '.join(flags)}: "
                      + "\n".join(r.stderr.strip().splitlines()[-20:]))
    tmp.unlink(missing_ok=True)
    raise BuildError(f"building {lib_name} from {src.name} failed:\n"
                     + "\n".join(errors))
