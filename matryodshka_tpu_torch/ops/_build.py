"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`), one
`nvcc` process per source, all started together, and the objects are linked
into one shared library with a plain C interface, loaded through `ctypes`.
The build runs at the first CUDA launch, not at import, and lands in
`_build/` beside this package (listed in `.gitignore`), under a name that
carries a hash of the sources and flags: a changed source rebuilds, an
unchanged one loads in milliseconds. The compiler's output, `-Xptxas -v`
register and spill counts included, is kept beside the library as
`<name>.log`.

`op_library()` builds a second, self-contained library,
`libmatry_ops-<hash>.so`: `csrc/sweep_op.cpp`, which registers the custom
op `matry::sweep_volume` with libtorch's dispatcher (`TORCH_LIBRARY`), and,
where CUDA is available, `csrc/sweep.cu` linked into it, so that a process
loads it with `torch.ops.load_library` and needs no module of the port (an
exported full program, `cli/export.py`). `g++` compiles `sweep_op.cpp`
against the wheel's libtorch headers (its CPU and Meta implementations;
with `-DMATRY_WITH_CUDA` the CUDA one too, beside `nvcc`'s object of
`sweep.cu`). It lands in `_build/` under a hash of its sources, flags and
`torch.__version__`, built under a file lock and renamed into place.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from matryodshka_tpu_torch import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of each kernel entry: every pointer and the stream are
#: c_void_p; each function returns its launch's cudaError_t (except
#: matry_conv_plan and matry_wgrad_plan, plan codes, matry_conv_smem, a
#: byte count, and matry_conv_stats_blocks, a count).
SIGNATURES = {
    "matry_sweep": [_P] * 7 + [_I] * 5 + [_P],
    "matry_sweep_row_params": [_P] * 10 + [_I] * 4 + [_P],
    "matry_sweep_assembled": [_P] * 10 + [_I] * 10 + [_P],
    "matry_conv": [_P] * 5 + [_I] * 20 + [_P] * 2 + [_I] * 3 + [_P] * 3
    + [_I] + [_P] * 3 + [_I, _P],
    "matry_conv_plan": [_I] * 5,
    "matry_conv_smem": [_I] * 8,
    "matry_conv_stats_blocks": [_I] * 8,
    "matry_conv_wgrad": [_P] * 5 + [_I] * 6 + [ctypes.c_longlong, _I, _I,
                                               _P],
    "matry_wgrad_plan": [_I] * 6,
    "matry_render": [_P, _P, _P, ctypes.c_longlong, _P, ctypes.c_longlong]
    + [_P] * 4 + [_I] * 6 + [ctypes.c_float, _P],
    "matry_uv_project": [_P, ctypes.c_longlong, _P, ctypes.c_longlong]
    + [_P] * 5 + [_I] * 4 + [_P],
    "matry_render_layers": [_P, _P, ctypes.c_longlong, _P, ctypes.c_longlong]
    + [_P] * 5 + [_I] * 6 + [ctypes.c_float, _P],
    "matry_render_layers_partial": [_P, _P, ctypes.c_longlong, _P,
                                    ctypes.c_longlong] + [_P] * 6
    + [_I] * 7 + [_P],
    "matry_probe_trig": [_P, _P, ctypes.c_longlong, _P],
    "matry_probe_roll": [_P, _P, ctypes.c_longlong, _I, _I, _I, _P],
    "matry_probe_window_shift": [_P, _P, _I, _I, _I, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and in "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"matry_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists (the
    compile inside a setup span, `_build.build`)."""
    so = library_path()
    if so.exists():
        return so
    with trace.setup_span("_build.build"):
        _compile(so)
    return so


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    objs, procs = [], []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs)]
        log, failed = [], []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        if not failed:
            done = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  check=False)
            log.append(" ".join(link) + "\n" + done.stdout)
            if done.returncode != 0:
                failed.append(done.stdout)
        so.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-4000:])
        os.replace(tmp, so)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)


#: The op library's sources: its C++ registration, and K1 with the headers
#: it includes (linked in where CUDA is available).
OP_SOURCE = CSRC / "sweep_op.cpp"
OP_CUDA_SOURCES = [CSRC / "sweep.cu", CSRC / "sweep_window.cuh",
                   CSRC / "project.cuh", CSRC / "common.cuh"]
CXX_FLAGS = ["-std=c++20", "-O2", "-fPIC"]


def _torch_dirs():
    root = Path(torch.__file__).resolve().parent
    return root / "include", root / "lib"


def _op_flags(cuda: bool):
    """(compile flags, link flags) of sweep_op.cpp."""
    inc, libdir = _torch_dirs()
    cflags = [*CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI="
              f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}", f"-I{inc}",
              f"-I{inc / 'torch' / 'csrc' / 'api' / 'include'}"]
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        cuda_root = Path(_nvcc()).resolve().parent.parent
        cflags += ["-DMATRY_WITH_CUDA", f"-I{cuda_root / 'include'}"]
        # the CUDA runtime linked statically, as nvcc links the kernel
        # library: the library needs no libcudart of the toolkit's version
        libs += ["-ltorch_cuda", "-lc10_cuda",
                 f"-L{cuda_root / 'lib64'}", "-lcudart_static", "-ldl",
                 "-lrt", "-lpthread"]
    return cflags, [f"-L{libdir}", *libs, f"-Wl,-rpath,{libdir}"]


def op_library_path(cuda: bool) -> Path:
    cflags, lflags = _op_flags(cuda)
    h = hashlib.sha256(" ".join([torch.__version__, *NVCC_FLAGS, *cflags,
                                 *lflags]).encode())
    for src in [OP_SOURCE, *(OP_CUDA_SOURCES if cuda else [])]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmatry_ops-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _locked(path: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def op_library() -> Path:
    """The op library (matry::sweep_volume), built unless it exists: with
    K1's CUDA implementation where torch.cuda.is_available() (nvcc
    missing there raises), else its CPU and Meta implementations alone."""
    cuda = torch.cuda.is_available()
    if cuda:
        _nvcc()
    so = op_library_path(cuda)
    if so.exists():
        return so
    with _locked(so.with_suffix(".lock")):
        if not so.exists():
            _build_op_library(so, cuda)
    return so


def _build_op_library(so: Path, cuda: bool) -> None:
    cflags, lflags = _op_flags(cuda)
    tag = f"{so.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    objs = [BUILD_DIR / f"{tag}.sweep_op.o"]
    cmds = [["g++", *cflags, "-c", str(OP_SOURCE), "-o", str(objs[0])]]
    if cuda:
        objs.append(BUILD_DIR / f"{tag}.sweep.o")
        cmds.append([_nvcc(), *NVCC_FLAGS, "-c", str(OP_CUDA_SOURCES[0]),
                     "-o", str(objs[1])])
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    try:
        log, failed = [], []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        if not failed:
            link = ["g++", "-shared", "-o", str(tmp), *map(str, objs),
                    *lflags]
            done = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  check=False)
            log.append(" ".join(link) + "\n" + done.stdout)
            if done.returncode != 0:
                failed.append(done.stdout)
        so.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("the op library's build failed:\n"
                               + "\n".join(failed)[-4000:])
        os.replace(tmp, so)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (the load inside a
    setup span, `_build.lib`)."""
    global _lib
    if _lib is None:
        with trace.setup_span("_build.lib"):
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call the library's kernel entry `name` (a key of SIGNATURES) with
    args, inside a span `launch.<name>`; raise if it reported a CUDA
    error."""
    with trace.span("launch." + name):
        check(getattr(lib(), name)(*args), name)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def require(cond: bool, msg) -> None:
    """Argument check for a kernel wrapper (kept under python -O). msg: the
    error's text, or a callable that makes it (a launch path that is
    called every frame formats nothing while its checks pass)."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def geometry_args(what, tgt_pose, tgt_pos, radii, b, dev):
    """The kernels' pose, position and radii arguments: (pose pointer,
    pose batch stride, position pointer, position batch stride, radii
    pointer). Each pose is read as a row-major 4x4, each position as 3
    consecutive floats."""
    require(tgt_pose.device == dev and tgt_pose.dtype == torch.float32
            and tuple(tgt_pose.shape) == (b, 4, 4)
            and tgt_pose.stride()[1:] == (4, 1),
            f"{what}: tgt_pose {tgt_pose.dtype} {tuple(tgt_pose.shape)} "
            f"strides {tgt_pose.stride()}")
    require(tgt_pos.device == dev and tgt_pos.dtype == torch.float32
            and tuple(tgt_pos.shape) == (b, 3) and tgt_pos.stride(1) == 1,
            f"{what}: tgt_pos {tgt_pos.dtype} {tuple(tgt_pos.shape)}")
    require(radii.device == dev and radii.dtype == torch.float32
            and radii.dim() == 1 and radii.is_contiguous(),
            f"{what}: radii {radii.dtype} {tuple(radii.shape)}")
    return (tgt_pose.data_ptr(), tgt_pose.stride(0), tgt_pos.data_ptr(),
            tgt_pos.stride(0), radii.data_ptr())
