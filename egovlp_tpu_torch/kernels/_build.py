"""Build and load the hand-written CUDA kernels (``kernels/csrc``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
goes to ``build/egovlp_kernels/`` under the repository root, named by a
hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is.  Nothing is built when this module is
imported: ``load_library()`` builds at first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "egovlp_kernels"
SOURCES = ("space_attention_fwd.cu", "time_attention_fwd.cu",
           "space_attention_bwd.cu", "time_attention_bwd.cu",
           "grouped_attention_fwd.cu", "grouped_attention_bwd.cu",
           "time_attention_hs_fwd.cu", "time_attention_hs_bwd.cu",
           "layer_norm_fwd.cu", "layer_norm_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD = ([_P] * 6 + [_I] * 5 + [ctypes.c_float, _I, _I, _P], _I)
_BWD = ([_P] * 11 + [_I] * 5 + [ctypes.c_float, _I, _I, _P], _I)
# head-split kernels: [BH, G, L, hd] (K4) or [BH, f, n, hd] (K5, then its
# body), q scaled
_HS_FWD = ([_P] * 6 + [_I] * 4 + [_I, _I, _P], _I)
_HS_BWD = ([_P] * 11 + [_I] * 4 + [_I, _I, _P], _I)
_K5_FWD = ([_P] * 6 + [_I] * 5 + [_I, _I, _P], _I)
_K5_BWD = ([_P] * 11 + [_I] * 5 + [_I, _I, _P], _I)
# LayerNorm (K3): x, scale, bias, y, mu, rstd; rows, D, eps / x, dy, scale,
# mu, rstd, dx, part; rows, D
_LN_FWD = ([_P] * 6 + [_I, _I, ctypes.c_float, _I, _I, _P], _I)
_LN_BWD = ([_P] * 7 + [_I] * 4 + [_P], _I)
# (L, hd) -> registers, local bytes and shared memory of a bf16
# tensor-core kernel; (F, dtype) -> the same of a K2 or K5 streaming
# instantiation
_ATTRIBUTES = ([_I, _I] + [ctypes.POINTER(_I)] * 3, _I)
# dtype -> the same of a K3 kernel
_LN_ATTRIBUTES = ([_I] + [ctypes.POINTER(_I)] * 3, _I)
_SIGNATURES = {
    "egovlp_space_attention_fwd": _FWD,
    "egovlp_time_attention_fwd": _FWD,
    "egovlp_space_attention_bwd": _BWD,
    "egovlp_time_attention_bwd": _BWD,
    "egovlp_grouped_attention_fwd": _HS_FWD,
    "egovlp_grouped_attention_bwd": _HS_BWD,
    "egovlp_time_attention_hs_fwd": _K5_FWD,
    "egovlp_time_attention_hs_bwd": _K5_BWD,
    "egovlp_time_attention_fwd_attributes": _ATTRIBUTES,
    "egovlp_time_attention_bwd_attributes": _ATTRIBUTES,
    "egovlp_time_attention_hs_fwd_attributes": _ATTRIBUTES,
    "egovlp_time_attention_hs_bwd_attributes": _ATTRIBUTES,
    "egovlp_space_attention_fwd_attributes": _ATTRIBUTES,
    "egovlp_grouped_attention_fwd_attributes": _ATTRIBUTES,
    "egovlp_space_attention_bwd_attributes": _ATTRIBUTES,
    "egovlp_grouped_attention_bwd_attributes": _ATTRIBUTES,
    "egovlp_layer_norm_fwd": _LN_FWD,
    "egovlp_layer_norm_bwd": _LN_BWD,
    "egovlp_layer_norm_fwd_attributes": _LN_ATTRIBUTES,
    "egovlp_layer_norm_bwd_attributes": _LN_ATTRIBUTES,
    "egovlp_cuda_error_string": ([_I], ctypes.c_char_p),
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def library_path(nvcc: str) -> pathlib.Path:
    h = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"libegovlp_kernels-{h.hexdigest()[:16]}.so"


def build(nvcc: str, out: pathlib.Path) -> None:
    """Compile every source into ``out`` (written atomically): one nvcc
    process per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"{pathlib.Path(s).stem}.o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for s, o in zip(SOURCES, objs)]
        errors = []
        for s, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {s} failed ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        lib = os.path.join(tmp, out.name)
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(lib, out)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build the kernels if needed and load them, with every C signature
    declared (pointers and the stream as ``c_void_p``)."""
    nvcc = find_nvcc()
    path = library_path(nvcc)
    if not path.exists():
        build(nvcc, path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
