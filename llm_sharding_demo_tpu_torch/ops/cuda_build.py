"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries go to
``build/torch_kernels/`` beside the package, named by a hash of the
source and the compiler flags, so an edited source rebuilds and an
unchanged one is reused. The build happens at first use, never at
import: importing any module of the package needs no GPU and no nvcc.

Every kernel has one ``Kernel`` object with a plain integer launch count
(``Kernel.launches``), raised by one each time its wrapper launches it
and nowhere else, so a run can show which kernels its main path went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME``, ``$PATH`` or the default toolkit path."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from csrc/ at first use")


class KernelLibrary:
    """One ``csrc`` source, built into its own shared library on demand."""

    def __init__(self, source: str, functions: Dict[str, Sequence],
                 error_fn: str, defines: Sequence[str] = ()):
        self.source = os.path.join(CSRC_DIR, source)
        self.functions = dict(functions)
        self.error_fn = error_fn
        # extra nvcc flags (``-D`` switches of the source), hashed into the
        # library's name
        self.flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    @property
    def path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read())
        digest.update(" ".join(self.flags).encode())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless its library already exists.
        The output goes to a temporary name and is renamed into place when
        ``finish_build`` sees the compiler succeed, so two processes that
        build at once never load a half-written file."""
        if os.path.exists(self.path):
            if self.build_seconds is None:
                self.build_seconds = 0.0  # built by an earlier process
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{self.path}.tmp{os.getpid()}"
        cmd = [find_nvcc(), *self.flags, "-o", tmp, self.source]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp_path = tmp
        proc.t0 = time.perf_counter()
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        self.build_seconds = time.perf_counter() - proc.t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(proc.tmp_path, self.path)

    def load(self):
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(self.path)
                for name, argtypes in self.functions.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                err = getattr(lib, self.error_fn)
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


class Kernel:
    """A kernel's C entry point plus its launch count."""

    def __init__(self, name: str, library: KernelLibrary, symbol: str):
        self.name = name
        self.library = library
        self.symbol = symbol
        self.launches = 0
        self._lock = threading.Lock()

    def launch(self, device, *args) -> None:
        """Call the C entry point with ``device`` current (it launches on
        the given stream of that device and returns the launch's error
        code); raise on any error, count on success."""
        import torch
        lib = self.library.load()
        with torch.cuda.device(device):
            code = getattr(lib, self.symbol)(*args)
        if code != 0:
            msg = getattr(lib, self.library.error_fn)(code).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} "
                               f"(cudaError {code})")
        with self._lock:
            self.launches += 1


DECODE_ATTENTION_LIB = KernelLibrary(
    "decode_attention.cu",
    {"decode_attention_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _F, _P)},
    "decode_attention_error")
QUANT_LIB = KernelLibrary(
    "quant.cu",
    {"quant_linear_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
     "quant_head_launch": (_P, _P, _P, _I, _I, _I, _I, _P)},
    "quant_error")
DECODE_LAYER_LIB = KernelLibrary(
    "decode_layer.cu",
    {"decode_layers_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _P),
     "decode_layers_workspace_floats": (_I, _I, _I, _I),
     "decode_layers_llama_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
     "decode_layers_llama_workspace_floats": (_I, _I, _I, _I, _I, _I)},
    "decode_layers_error")
FLASH_ATTENTION_LIB = KernelLibrary(
    "flash_attention.cu",
    {"flash_fwd_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
     "flash_bwd_dq_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                             _P),
     "flash_bwd_dkv_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _F, _P),
     "flash_fwd_smem_bytes": (),
     "flash_dkv_smem_bytes": ()},
    "flash_attention_error")
LIBRARIES = (DECODE_ATTENTION_LIB, QUANT_LIB, DECODE_LAYER_LIB,
             FLASH_ATTENTION_LIB)

DECODE_ATTENTION = Kernel("decode_attention", DECODE_ATTENTION_LIB,
                          "decode_attention_launch")
QUANT_LINEAR = Kernel("quant_linear", QUANT_LIB, "quant_linear_launch")
QUANT_HEAD = Kernel("quant_head", QUANT_LIB, "quant_head_launch")
DECODE_LAYERS = Kernel("decode_layers", DECODE_LAYER_LIB,
                       "decode_layers_launch")
DECODE_LAYERS_LLAMA = Kernel("decode_layers_llama", DECODE_LAYER_LIB,
                             "decode_layers_llama_launch")
FLASH_FWD = Kernel("flash_fwd", FLASH_ATTENTION_LIB, "flash_fwd_launch")
FLASH_BWD_DQ = Kernel("flash_bwd_dq", FLASH_ATTENTION_LIB,
                      "flash_bwd_dq_launch")
FLASH_BWD_DKV = Kernel("flash_bwd_dkv", FLASH_ATTENTION_LIB,
                       "flash_bwd_dkv_launch")
KERNELS = (DECODE_ATTENTION, QUANT_LINEAR, QUANT_HEAD, DECODE_LAYERS,
           DECODE_LAYERS_LLAMA, FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV)


def build_all() -> List[KernelLibrary]:
    """Build every library at once (one nvcc per source, all started
    together) and load them; returns the libraries with their build
    seconds and compiler logs."""
    procs = [lib.start_build() for lib in LIBRARIES]
    errors = []
    for lib, proc in zip(LIBRARIES, procs):
        try:
            lib.finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in LIBRARIES:
        lib.load()
    return list(LIBRARIES)


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        with k._lock:
            k.launches = 0


def stream_handle(tensor) -> int:
    """PyTorch's current CUDA stream on the tensor's device, as an int."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


def dtype_code(tensor) -> int:
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if tensor.dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got "
                        f"{tensor.dtype}")
    return codes[tensor.dtype]
