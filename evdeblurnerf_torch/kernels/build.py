"""Build the hand-written CUDA kernels into one shared library and load it.

``nvcc`` compiles every ``evdeblurnerf_torch/csrc/*.cu`` for Hopper
(``sm_90a``), one process per source, all started together, and links the
objects into a library with a plain C interface, loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a cold build takes seconds, not
minutes. The build runs at first use, from the sources in the
checkout, into ``build/evdeblurnerf_torch/`` beside the package; the file
name carries a digest of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.

A missing ``nvcc`` or a failed compile raises with nvcc's own output:
there is no fallback to the plain versions here or in any wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "evdeblurnerf_torch"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

# every pointer and the stream are c_void_p: a bare Python int would be
# passed as a 32-bit C int and cut the address
SIGNATURES = {
    # x, idx, out, rows, S, S2, device, stream
    "evdn_permute_lanes": (_P, _P, _P, _L, _I, _I, _I, _P),
    # x, idx, out, rows, C, S, S2, device, stream
    "evdn_permute_lanes_3d": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
    # cdf, bins, below, above, 4 outputs, rows, M, Mb, N, device, stream
    "evdn_cdf_take": (_P,) * 8 + (_L, _I, _I, _I, _I, _P),
    # xyz, 3 packed planes, 3 packed lines, out, n,
    # (H, W, D, C) x 3 projections, tables (0 f32, 1 bf16 rows, 2 bf16 rows
    # and math), mode (0 scalar, 1 vector, 2 vector over unpacked tables),
    # device, stream
    "evdn_triplane_features": (_P,) * 8 + (_L,) + (_I,) * 12
    + (_I, _I, _I, _P),
    # xyz, 3 packed planes, 3 packed lines, g, 3 plane grads, 3 line-row
    # grads (fused: the 3 raw line grads), 3 line-row indices, xyz grad, n,
    # (H, W, D, C) x 3 projections, tables (0 f32, 1 bf16), mode (0 scalar,
    # 1 float4, 2 fused), device, stream
    "evdn_triplane_features_bwd": (_P,) * 18 + (_L,) + (_I,) * 12
    + (_I, _I, _I, _P),
    # idx, g, out, n, D, W, round g to bf16 (precision "default"), device,
    # stream
    "evdn_line_grad": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
    # 3 idx, 3 g, 3 out, n, (D, W) x 3 tables, device, stream
    "evdn_line_grad_tables": (_P,) * 9 + (_L,) + (_I,) * 6 + (_I, _P),
    # plane, fu, fv, oy, ox, out, groups, H, W, C, TH, TW, device, stream
    "evdn_tiled_plane_gather": (_P,) * 6 + (_L,) + (_I,) * 5 + (_I, _P),
}

_lock = threading.Lock()
_lib = None
# kernel name -> its C entry point ``evdn_<name>`` in the loaded library;
# filled by load(), read by kernels.launch without a lock
ENTRY = {}


def sources():
    """The CUDA sources and headers the library is built from."""
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``DEFAULT_CUDA_HOME/bin/nvcc``, else
    ``nvcc`` on ``PATH``; raises when there is none."""
    looked = []
    if os.environ.get("CUDA_HOME"):
        looked.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    looked.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for cand in looked:
        if cand.is_file():
            return str(cand)
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError(
        "nvcc not found (looked in " + ", ".join(map(str, looked))
        + " and on PATH): the CUDA kernels of evdeblurnerf_torch need the "
        "CUDA toolkit to build; set CUDA_HOME to its root")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libevdn_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands side by side; returns [(cmd, returncode, output)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    done = [(cmd, p.communicate()[0]) for cmd, p in procs]
    return [(cmd, p.returncode, text)
            for (cmd, p), (_, text) in zip(procs, done)]


def build() -> Path:
    """Compile the library unless a build of these exact sources exists;
    returns its path. nvcc's output (``-Xptxas -v``: registers, shared
    memory and spills of every kernel) is kept beside it as ``.log``."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cu = [s for s in sources() if s.suffix == ".cu"]
    objs = [tmp.with_name(f"{tmp.stem}.{s.stem}.o") for s in cu]
    compiled = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                         for s, o in zip(cu, objs)])
    if all(rc == 0 for _, rc, _ in compiled):
        compiled += _run_all([[nvcc, "-shared", *NVCC_FLAGS[:2], "-o",
                               str(tmp), *map(str, objs)]])
    out.with_suffix(".log").write_text(
        "".join(f"$ {' '.join(cmd)}\n{text}" for cmd, _, text in compiled))
    for o in objs:
        o.unlink(missing_ok=True)
    for cmd, rc, text in compiled:
        if rc != 0:
            raise RuntimeError(f"nvcc failed with exit code {rc}: "
                               f"{' '.join(cmd)}\n{text}")
    # atomic publish: a concurrent build of the same sources either
    # finds the finished file or replaces it with an identical one
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process).
    Once it is loaded no lock is taken; :data:`ENTRY` then holds every
    entry point by its kernel's name."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                ENTRY[name[len("evdn_"):]] = fn
            lib.evdn_error_string.argtypes = [ctypes.c_int]
            lib.evdn_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib
