"""Build directory and shared-library compilation for the port.

Everything the port generates at run time -- the g++ host builders, the
nvcc kernel libraries, the scene cache -- goes to ONE git-ignored
directory, `toyrenderer_tpu_torch/build/`.  Libraries are built at first
use and rebuilt when their source is newer.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "build"


def shared_library(compiler: list[str], src: Path, name: str,
                   timeout: float = 600.0, headers: tuple = ()) -> Path:
    """Compile `src` into BUILD_DIR/`name` with `compiler` (the command
    and its flags, without the source and output); return the path.
    The library is rebuilt when `src` or one of the `headers` it
    includes is newer.

    Raises RuntimeError with the compiler's output when the build fails;
    a successful build leaves that output in `name`.log beside the
    library.  The library is written under a temporary name and renamed
    into place, so concurrent processes never load a half-written file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / name
    newest = max(f.stat().st_mtime for f in (src, *headers))
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    fd, tmp = tempfile.mkstemp(prefix=name + ".", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [*compiler, str(src), "-o", tmp], capture_output=True,
            text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {src.name} failed ({' '.join(compiler)}):\n"
                f"{proc.stdout}{proc.stderr}")
        (BUILD_DIR / (name + ".log")).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
