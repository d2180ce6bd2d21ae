"""Build the repo's host C++ libraries (``native/*.cpp``) with ``g++`` and load
them with ctypes (counterpart of ``openwakeword_tpu.utils.native_lib``).

The JAX package builds next to its sources with ``make -C native``; the port
leaves ``native/`` untouched and compiles the same source, with the same
flags as ``native/Makefile``, into ``build/openwakeword_tpu_torch/native/<hash>/``
beside the package. The directory is keyed by a hash of the source, the
flags and the host's CPU model (``-march=native`` code runs only on the CPU
it was built for), so an edited source or another host rebuilds and an
unchanged one loads at once. The
library is built under a private name and renamed into place, so a
concurrent process never loads a half-written file.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

from openwakeword_tpu_torch.utils.cuda_build import BUILD_ROOT

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native", "-shared")


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return ""


def build_and_load(so_name: str, source_name: str, libs=("-lpthread",)) -> ctypes.CDLL:
    """Load ``<so_name>`` built from ``native/<source_name>``, building it
    first when this source and these flags have no build yet.

    Raises ImportError when the library cannot be produced (missing source,
    no ``g++``, a failing compile), so callers treat "no native library" as
    one condition, as the JAX package's loader does.
    """
    src = NATIVE_DIR / source_name
    if not src.exists():
        raise ImportError(f"native source {src} not found")
    flags = (*CXX_FLAGS, *libs)
    key = " ".join(flags) + _cpu_model()
    digest = hashlib.sha256(key.encode() + src.read_bytes()).hexdigest()[:16]
    out_dir = BUILD_ROOT / "native" / digest
    lib_path = out_dir / so_name
    if not lib_path.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise ImportError(f"building {so_name} needs g++, which is not on PATH")
        out_dir.mkdir(parents=True, exist_ok=True)
        work = pathlib.Path(tempfile.mkdtemp(dir=out_dir))
        try:
            cmd = [cxx, *CXX_FLAGS, "-o", str(work / so_name), str(src), *libs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise ImportError(f"building {so_name} failed ({proc.returncode}): "
                                  f"{' '.join(cmd)}\n{proc.stderr[-400:]}")
            os.replace(work / so_name, lib_path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return ctypes.CDLL(str(lib_path))
