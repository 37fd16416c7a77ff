"""Build or locate the native C++ components (native/*.cpp) for the port.

The counterpart of d3d12_deferred_renderer_tpu/utils/native_build.py.  Both
ctypes bindings (models/native.py, the OBJ loader; runtime/native_sink.py,
the frame sink) use the shared library when it exists and is at least as
new as its source and the Makefile, and otherwise build it with the
Makefile's own rule.  The port builds into build/native/ beside the
package and writes nothing into native/, where the JAX package keeps its
build: make runs in a fresh directory under build/native/ (the Makefile
read from native/, the source linked in beside it) and the library is
moved into place with os.replace, so a process never loads a half-written
file while another one builds.
"""
from __future__ import annotations

import os
import subprocess
import tempfile

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
NATIVE_DIR = os.path.join(ROOT, "native")
BUILD_DIR = os.path.join(ROOT, "build", "native")
_build_failed: set = set()


def ensure_built(lib_name: str, src_name: str) -> "str | None":
    """Return the path to build/native/<lib_name>, (re)building it with
    native/Makefile when it is missing or older than native/<src_name> or
    the Makefile.  Returns None (and remembers the failure) when the
    toolchain is unavailable or the build fails."""
    lib_path = os.path.join(BUILD_DIR, lib_name)
    src = os.path.join(NATIVE_DIR, src_name)
    makefile = os.path.join(NATIVE_DIR, "Makefile")
    inputs = [p for p in (src, makefile) if os.path.exists(p)]
    if os.path.exists(lib_path) and (
        not inputs or os.path.getmtime(lib_path) >= max(os.path.getmtime(p) for p in inputs)
    ):
        return lib_path
    if lib_name in _build_failed:
        return None
    if not (os.path.exists(src) and os.path.exists(makefile)):
        _build_failed.add(lib_name)
        return None
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            os.symlink(src, os.path.join(tmp, src_name))
            subprocess.run(
                ["make", "-C", tmp, "-f", makefile, lib_name],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(os.path.join(tmp, lib_name), lib_path)
    except (OSError, subprocess.SubprocessError):
        _build_failed.add(lib_name)
        return None
    return lib_path
