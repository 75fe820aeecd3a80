"""Build and load the port's CUDA kernels, and the checks every launch
shares.

The sources under ``repro_torch/csrc/`` are compiled for Hopper
(``sm_90a``) with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``.  The build happens at first use, into
``repro_torch/_build/`` (ignored by git), one ``nvcc`` per source started
together and then one link; the library's name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one
loads the library already there.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")

#: Dynamic shared memory a block may use on an H100 (227 KB).
MAX_SMEM_BYTES = 232_448

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> (argtypes, restype)
_SIGNATURES = {
    "repro_leverage": ((_vp, _vp, _vp, _i, _ll, _i, _ll, _ll, _vp), _i),
    "repro_leverage_wide": ((_vp, _vp, _vp, _i, _ll, _i, _i, _ll, _ll, _vp), _i),
    "repro_leverage_tiled": ((_vp, _vp, _vp, _vp, _i, _ll, _i, _i, _ll, _ll, _ll, _vp),
                             _i),
    "repro_weighted_gram": ((_vp, _vp, _vp, _vp, _i, _ll, _i, _ll, _ll, _ll,
                             _vp), _i),
    "repro_kmeans_assign": ((_vp, _vp, _vp, _vp, _i, _ll, _i, _i, _i, _ll, _ll,
                             _vp), _i),
    "repro_kmeans_assign_tiled": ((_vp,) * 6 + (_i, _ll) + (_i,) * 8 + (_ll, _ll, _vp), _i),
    "repro_kmeans_assign_update": ((_vp,) * 9 + (_i, _ll, _i, _i, _i, _i, _ll,
                                                 _ll, _ll, _ll, _vp), _i),
    "repro_kmeans_assign_update_general": ((_vp,) * 11 + (_i, _ll) + (_i,) * 9
                                           + (_ll,) * 4 + (_vp,), _i),
    "repro_categorical": ((_vp, _i, ctypes.c_ulonglong, _vp, _ll, _ll, _ll, _vp, _i,
                           _ll, _i, _ll, _vp, _vp, _vp, _vp), _i),
    "repro_error_string": ((_i,), ctypes.c_char_p),
}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME`` (or
    the toolkit's default prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built from source at first use and need the CUDA toolkit")
    return str(path)


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds):
    """Start every command at once, wait for all; raise with the compiler
    output of the first that failed.  Returns the combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile the library if this source hash has none yet; return its
    path.  Concurrent builds each write a private temporary and the
    last rename wins with identical bytes."""
    lib = BUILD_DIR / f"libreprotorch_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources()]
        log = _run([[cc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                    for s, o in zip(sources(), objs)])
        out = Path(tmp) / lib.name
        log += _run([[cc, *ARCH_FLAGS, "-shared", "-o", str(out),
                      *map(str, objs)]])
        (BUILD_DIR / f"{lib.stem}.log").write_text(log)
        os.replace(out, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every
    function's ``argtypes`` and ``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = res
    return lib


def timed_build() -> float:
    """Build (or find) and load the library; the seconds it took."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().repro_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} ({msg})")


def batch_shape(lead_a, lead_b, what: str):
    """The launch batch of two operands' leading dims, as the reference's
    vmap reads them: equal dims, or one side without any (shared across the
    batch).  Returns ``(batch, a_batched, b_batched)``."""
    lead_a, lead_b = tuple(lead_a), tuple(lead_b)
    if lead_a and lead_b and lead_a != lead_b:
        raise ValueError(f"{what}: batch dims {lead_a} and {lead_b} differ")
    return lead_a or lead_b, bool(lead_a), bool(lead_b)


#: Device types whose tensors take a kernel's plain version: the CPU computes
#: it; ``meta`` (the dry run's device) carries only shapes through it.
PLAIN_DEVICES = ("cpu", "meta")


def launch_device(*tensors):
    """The one device all ``tensors`` share; raises on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    (dev,) = devs
    return dev
