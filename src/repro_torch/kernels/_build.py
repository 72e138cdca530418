"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` is compiled on first use for ``sm_90a`` into a
shared library with a plain C interface (one ``nvcc`` per source, started
together), under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``); kernels whose entry points share a source (``wkv_fwd``
and ``wkv_bwd``) share its library. A library's file name carries a
digest of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. If ``nvcc`` is missing or a build fails, this
raises: nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel name -> (source file, C entry point, argtypes)
KERNELS = {
    "fused_step": ("fused_step.cu", "fused_step_launch", [_P] * 16 + [_I] * 6 + [_P]),
    "cnn_trunk": ("cnn_trunk.cu", "cnn_trunk_launch", [_P] * 8 + [_I] * 6 + [_P]),
    "conv2s": ("conv2s.cu", "conv2s_launch", [_P] * 4 + [_I] * 5 + [_P]),
    "decode_attn": ("decode_attn.cu", "decode_attn_launch", [_P] * 9 + [_I] * 15 + [_P]),
    "wkv_fwd": ("wkv.cu", "wkv_fwd_launch", [_P] * 9 + [_I] * 5 + [_P]),
    "wkv_bwd": ("wkv.cu", "wkv_bwd_launch", [_P] * 14 + [_I] * 5 + [_P]),
}


@dataclasses.dataclass
class Built:
    path: Path
    log: str  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


_built: Dict[str, Built] = {}
_entry: Dict[str, Callable] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all running at once."""
    names = list(KERNELS if names is None else names)
    todo = {}  # source -> (its library, the kernels it holds)
    for name in names:
        if name in _built:
            continue
        source = KERNELS[name][0]
        out = _library_path(source)
        if out.is_file():
            _built[name] = Built(out, "")
        else:
            todo.setdefault(source, (out, []))[1].append(name)
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for source, (out, _) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for source, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{source} (exit {proc.returncode}):\n{log}")
                continue
            out, held = todo[source]
            os.replace(tmp, out)
            for name in held:
                _built[name] = Built(out, log)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: _built[n] for n in names}


def load(name: str):
    """The C entry point of kernel ``name`` (built on first use)."""
    fn = _entry.get(name)
    if fn is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _, symbol, argtypes = KERNELS[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entry[name] = fn
    return fn
