"""Build and load the CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` into a shared library with a plain C interface; the processes
run side by side.  The libraries land in ``build/torch_kernels/<hash>/``
at the repository root, where ``<hash>`` covers every file under
``csrc/`` (the shared ``*.cuh`` headers too) and the flags, so an edit
rebuilds and an unchanged tree reuses the build; each
library's ptxas report is kept beside it (``lib<name>.ptxas``), so a
reused build still reports it.  They are loaded with ``ctypes``.  A
missing ``nvcc`` or a failed build raises; nothing falls back.

Nothing here runs at import: the first call to :func:`library` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The tick kernels reproduce XLA's f32 rounding bit for bit, so nvcc may
# not contract a multiply and an add into an fma.  The model kernels are
# held to a tolerance and keep nvcc's default contraction.
EXACT = ("-fmad=false",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point, argument types and extra nvcc flags of each kernel's
# library (every entry point takes the stream last)
SIGNATURES = {
    "flow_agg": ("flow_agg_launch", (_P, _P, _P, _I, _I, _I, _I, _P), EXACT),
    "tick_rank": ("tick_rank_launch", (_P, _P, _I, _I, _I, _P), EXACT),
    "red_ecn": ("red_ecn_launch", (_P, _P, _P, _P, _P, _P, _I, _F, _F, _I,
                                   _I, _P, _P, _P, _P, _P), EXACT),
    "tick_draws": ("tick_draws_launch", (_P, _P, _I, _I, _P, _P, _P), EXACT),
    "spritz_select": ("spritz_select_launch", (_P, _P, _P, _P, _P, _P, _I,
                                               _I, _I, _P, _P, _P, _P),
                      EXACT),
    "weighted_sample": ("weighted_sample_launch",
                        (_P, _P, _P, _I, _I, _P, _P), EXACT),
    "flash_attention": ("flash_attention_launch",
                        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _F, _I, _I, _I, _P, _P, _P), ()),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
                            ()),
    "rwkv6_chunked": ("rwkv6_chunked_launch",
                      (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _P), ()),
    "rwkv6_chunked_bwd": ("rwkv6_chunked_bwd_launch",
                          (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _I, _I, _I, _I, _P), ()),
    "mamba_scan": ("mamba_scan_launch",
                   (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P), ()),
}
# entry points beside their library's own: name -> (library, C entry
# point, argument types)
EXTRA_ENTRIES = {
    "tick_rank_red_ecn": ("tick_rank", "tick_rank_red_ecn_launch",
                          (_P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _I, _I,
                           _I, _P, _P, _P, _P)),
    "mamba_scan_bwd": ("mamba_scan", "mamba_scan_bwd_launch",
                       (_P,) * 18 + (_I, _I, _I, _I, _P)),
}

_FUNCS: dict = {}
BUILD_INFO: dict = {}   # seconds, directory and ptxas report of the build


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the "
                           "CUDA toolkit (add its bin/ to PATH)")
    return path


def _digest() -> str:
    """Hash of the flags and of every file under ``csrc/`` (sources and
    the headers they share), sorted by name."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SIGNATURES):
        h.update(name.encode())
        h.update(" ".join(SIGNATURES[name][2]).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(path.relative_to(CSRC).as_posix().encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every kernel library that is not built yet; returns the
    library path of each kernel."""
    out = BUILD_ROOT / _digest()
    libs = {name: out / f"lib{name}.so" for name in SIGNATURES}
    todo = [n for n, p in libs.items() if not p.exists()]
    if todo:
        _compile(out, libs, todo)
    else:
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("dir", str(out))
    BUILD_INFO["ptxas"] = {n: p.with_suffix(".ptxas").read_text()
                           for n, p in libs.items()
                           if p.with_suffix(".ptxas").exists()}
    return libs


def _compile(out: Path, libs: dict[str, Path], todo: list[str]) -> None:
    out.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out / f".lib{name}.{os.getpid()}.so"
        cmd = [exe, *NVCC_FLAGS, *SIGNATURES[name][2], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:              # the report first: a library implies its report
            libs[name].with_suffix(".ptxas").write_text(log)
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    BUILD_INFO.update(seconds=time.perf_counter() - t0, dir=str(out))


def library(name: str):
    """The C launch function of kernel ``name``, building on first use."""
    fn = _FUNCS.get(name)
    if fn is None:
        libs = build()
        entries = {k: (k, sym, args) for k, (sym, args, _) in
                   SIGNATURES.items()}
        entries.update(EXTRA_ENTRIES)
        for kname, (lib, sym, argtypes) in entries.items():
            f = getattr(ctypes.CDLL(str(libs[lib])), sym)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            _FUNCS[kname] = f
        fn = _FUNCS[name]
    return fn
