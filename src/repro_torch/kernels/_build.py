"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each library of ``LIBRARIES`` (a ``csrc/<source>.cu`` and its defines)
becomes ``build/repro_torch/<name>-<hash>.so`` with a plain C interface
(no PyTorch headers, so a build takes seconds). The hash covers the
source, every ``csrc/*.cuh`` header, the defines and the flags, so an
edited source rebuilds and an unchanged one is reused. ``build_all``
starts one nvcc per library together. Nothing builds at import time: the
first CUDA launch of a kernel builds its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: library -> (source in csrc/, its defines). The decode kernels' two
#: sources build once for float32 and bfloat16 caches and once for each
#: other storage (decode_common.cuh by_storage), so the storages' nvcc runs
#: go side by side and each library holds one storage's instantiations.
LIBRARIES = {
    "fused_decode": ("fused_decode", ()),
    "gather_attention": ("gather_attention", ()),
    "approx_scores": ("approx_scores", ()),
    "flash_attention": ("flash_attention", ()),
    **{f"{src}_{tag}": (src, (f"-DLOKI_STORAGE_{tag.upper()}",))
       for tag in ("f16", "i8", "f8")
       for src in ("fused_decode", "gather_attention")},
}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the repro_torch CUDA kernels")
    return found


def _digest(name: str) -> str:
    src, defines = LIBRARIES[name]
    h = hashlib.sha256()
    for p in [CSRC / f"{src}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS + list(defines)).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str):
    """Start nvcc on one library; None when it exists already."""
    out = lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent loader never
    # sees a half-written library
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    src, defines = LIBRARIES[name]
    cmd = [nvcc(), *FLAGS, *defines, "-o", str(tmp), str(CSRC / f"{src}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, out, tmp = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        src, defines = LIBRARIES[name]
        raise RuntimeError(f"nvcc failed on csrc/{src}.cu "
                           f"{' '.join(defines)} (exit {proc.returncode}):"
                           f"\n{log}")
    os.replace(tmp, out)


def build_all(names: List[str] = list(LIBRARIES)) -> float:
    """Build every named library, one nvcc each, all started together.
    Returns the wall seconds it took (0 when all were built already)."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names}
    errors = []
    for n, p in procs.items():          # wait for every nvcc, then report
        try:
            _finish(n, p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    library's last build, or '' when it was built by another process."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass(name: str) -> str:
    """The built library's machine code as ``cuobjdump -sass`` prints it
    (to check which instructions a kernel was compiled to)."""
    tool = Path(nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib_path(name))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {name}: {out.stderr}")
    return out.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` of LIBRARIES, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError_t {rc}")


# ------------------------------------------------------------ launch helpers

def dtype_code(t, what: str) -> int:
    """0 for float32, 1 for bfloat16 — the launchers' dtype flags."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"{what}: dtype {t.dtype} not supported by the CUDA "
                        "kernels (float32 or bfloat16)")
    return codes[t.dtype]


#: cache storage of the decode kernels 1-5 -> (launcher code, library of
#: fused_decode's launchers, library of gather_attention's)
STORAGE = {"float32": (0, "fused_decode", "gather_attention"),
           "bfloat16": (1, "fused_decode", "gather_attention"),
           "float16": (2, "fused_decode_f16", "gather_attention_f16"),
           "int8": (3, "fused_decode_i8", "gather_attention_i8"),
           "float8_e4m3fn": (4, "fused_decode_f8", "gather_attention_f8")}
#: storage codes whose pools carry per-page float32 scales
SCALED_CODES = (3, 4)


def storage(t, what: str):
    """(code, fused library, attention library) of a cache's storage."""
    name = str(t.dtype).replace("torch.", "")
    if name not in STORAGE:
        raise TypeError(f"{what}: storage dtype {t.dtype} not supported by "
                        f"the CUDA decode kernels ({sorted(STORAGE)})")
    return STORAGE[name]


def storage_args(kernel: str, k_hat, v, scaled: bool):
    """Check a launch's cache storage and return ``storage(k_hat)``: int8
    and fp8 pools come with their page scales and other pools without
    (the kernels dequantize exactly the codes that are scaled), and the
    cache rows of the storages beside float32 and bfloat16 are whole
    16-byte runs (their rings copy nothing but 16-byte pieces)."""
    found = storage(k_hat, kernel)
    code = found[0]
    if (code in SCALED_CODES) != scaled:
        raise ValueError(
            f"{kernel}: a {k_hat.dtype} pool "
            + ("needs its per-page k_scale/v_scale" if code in SCALED_CODES
               else "takes no per-page scales (int8 and fp8 pools do)"))
    if code >= 2:
        for name, t in (("k_hat", k_hat), ("v", v)):
            if t is not None and (t.shape[-1] * t.element_size()) % 16:
                raise ValueError(
                    f"{kernel}: {name} rows of {t.shape[-1]} {t.dtype} "
                    "elements are not a whole number of 16-byte runs; the "
                    "CUDA kernels copy such a pool's rows in 16-byte "
                    "pieces only")
    return found


def scale_ptrs(kernel: str, device, *scales):
    """Device pointers of per-page scale vectors (null for None): float32,
    contiguous, 4-byte aligned, on ``device``."""
    import torch
    ptrs = []
    for s in scales:
        if s is None:
            ptrs.append(ctypes.c_void_p(None))
            continue
        if s.device != device or s.dtype != torch.float32 or \
                not s.is_contiguous() or s.data_ptr() % 4:
            raise ValueError(f"{kernel}: page scales must be contiguous "
                             f"float32 on {device}")
        ptrs.append(ctypes.c_void_p(s.data_ptr()))
    return ptrs


def table_arg(page_table, device):
    """The page table as the launchers take it: a contiguous int32 tensor
    on ``device`` and its column count, or (None, 0) for a contiguous
    cache."""
    import torch
    if page_table is None:
        return None, 0
    if page_table.ndim != 2:
        raise ValueError("page_table must be (B, n_pages)")
    return (page_table.to(device=device, dtype=torch.int32).contiguous(),
            page_table.shape[1])


def cuda_args(kernel: str, **tensors):
    """Check that every tensor lies on one CUDA device, is contiguous and
    16 B aligned, and return their device pointers in order (a null
    pointer for a None entry)."""
    dev = next(iter(tensors.values())).device
    ptrs = []
    for name, t in tensors.items():
        if t is None:
            ptrs.append(ctypes.c_void_p(None))
            continue
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")
        ptrs.append(ctypes.c_void_p(t.data_ptr()))
    return ptrs


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
