"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``repro_torch/csrc/`` expose plain C entry points.  On first
use this module compiles each ``.cu`` with ``nvcc`` for ``sm_90a`` (all
sources at once, in parallel), links them into one shared library keyed on
a hash of the sources and flags (linked against ``libcuda`` for the TMA
tensor maps of flash attention), and loads it with ``ctypes``.  The library
lands in ``build/repro_torch_kernels/`` at the root of the checkout, or in
``$REPRO_TORCH_BUILD_DIR``.  Nothing is built or loaded at import, so the
CPU-only tests import every module freely.

Each kernel wrapper adds one to its entry of :data:`LAUNCHES` where it
launches its kernel, so a run can show that its main path went through the
kernels; :func:`reset_launches` zeroes the counts.  A call captured into a
CUDA graph launches nothing then: :func:`captured_launches` takes what a
capture added back out of :data:`LAUNCHES`, and the graph's owner adds it
once a replay (:func:`add_launches`), so the counts stay true for replayed
rounds.

The launch path is kept short, since the wrappers run once per layer on
the serving path: :func:`launch` calls an entry point resolved once (no
lock and no attribute lookup after the first load), passes the raw handle
of the device's current stream (no ``torch.cuda.Stream`` object), and
enters a device guard only when the tensors' device is not the current
one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-lcuda",)  # cuTensorMapEncodeTiled (flash_attention)

LAUNCHES = {"bandwidth_solve": 0, "masked_bs_argmax": 0,
            "best_bs_argmax": 0, "fedavg_reduce": 0, "fedavg_reduce_int8": 0,
            "fedavg_segment_reduce": 0, "fedavg_segment_reduce_int8": 0,
            "sparsify_quantize": 0, "flash_attention": 0, "rmsnorm": 0,
            "ssd_scan": 0, "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
            "ssd_scan_bwd": 0}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    **{f"rmsnorm_{t}": (_P, _P, _P, _LL, _I, _F, _I, _I, _I, _P)
       for t in ("f32", "bf16")},
    **{f"flash_attention_{t}": (_P,) * 5 + (_I,) * 8 + (_F, _P)
       for t in ("f32", "bf16")},
    **{f"rmsnorm_bwd_{t}": (_P,) * 6 + (_LL, _I, _F, _I, _I, _I, _I, _P)
       for t in ("f32", "bf16")},
    **{f"flash_attention_bwd_{t}": (_P,) * 10 + (_I,) * 8 + (_F, _P)
       for t in ("f32", "bf16")},
    **{f"ssd_scan_{t}": (_P,) * 6 + (_I,) * 8 + (_P,)
       for t in ("f32", "bf16")},
    **{f"ssd_scan_bwd_{t}": (_P,) * 12 + (_I,) * 9 + (_P,)
       for t in ("f32", "bf16")},
    "bandwidth_solve_warp_f32": (_P, _P, _LL, _I, _P, _P, _P, _P)
    + (_I,) * 5 + (_P,),
    "bandwidth_solve_cluster_f32": (_P, _P, _LL, _I, _P, _P, _P, _P, _I, _LL,
                                    _I, _I, _I, _LL, _I, _I, _LL, _P, _P),
    **{f"masked_bs_argmax_{t}": (_P, _I, _P, _P, _LL, _I, _I, _I, _I, _LL,
                                 _P, _P, _P, _P)
       for t in ("f32", "bf16", "i8")},
    **{f"best_bs_argmax_{t}": (_P, _I, _P, _LL, _I, _I, _I, _I, _I, _P, _P)
       for t in ("f32", "bf16", "i8")},
    "fedavg_reduce_f32": (_P, _P, _LL, _LL, _P, _I, _I, _P),
    "fedavg_reduce_i8": (_P, _P, _LL, _LL, _P, _I, _I, _P),
    "fedavg_segment_reduce_f32": (_P, _P, _LL, _I, _LL, _P, _P),
    "fedavg_segment_reduce_i8": (_P, _P, _LL, _I, _LL, _P, _P),
    "sparsify_quantize_f32": (_P, _P, _P, _P, _LL, _LL, _I, _P, _P),
    # a graph's device-side while loop (csrc/graph_while.cu)
    "graph_while_begin": (_P, _P, _P, _P),
    "graph_while_end": (_P, ctypes.c_ulonglong, _P),
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_entries: dict[str, ctypes._CFuncPtr] = {}  # name -> resolved entry point
_workspaces: dict[tuple, torch.Tensor] = {}  # (name, device, stream) -> buf
_kept: list[torch.Tensor] = []  # retired and graph-owned workspaces
_holders: list["Held"] = []


class Held:
    """What captures keep alive for their graphs: buffers they allocated
    and read at every replay, and the memory pools they opened (a device
    loop's body).  The graphs' owner collects them (:func:`holding`) and
    drops them with its graphs (:meth:`release`)."""

    def __init__(self) -> None:
        self.tensors: list[torch.Tensor] = []
        self.pools: list[tuple] = []            # (device index, pool id)

    def release(self) -> None:
        """Drop the buffers and each pool's reference; call once the graphs
        that use them are reset.  A pool's memory goes back to the card at
        the next ``torch.cuda.empty_cache`` once no tensor holds it."""
        self.tensors.clear()
        for index, pool in self.pools:
            torch._C._cuda_releasePool(index, pool)
        self.pools.clear()


class holding:
    """``with holding(held):`` around a graph capture: what the capture
    keeps (:func:`keep`, :func:`keep_pool`) goes into ``held`` instead of
    living as long as the process."""

    def __init__(self, held: Held) -> None:
        self.held = held

    def __enter__(self) -> Held:
        _holders.append(self.held)
        return self.held

    def __exit__(self, *exc) -> None:
        _holders.pop()


def keep(*tensors: torch.Tensor) -> None:
    """Keep ``tensors`` alive as long as the graph being captured may
    replay: in the innermost :func:`holding`, else for the process."""
    if _holders:
        _holders[-1].tensors.extend(tensors)
    else:
        _kept.extend(tensors)


def keep_pool(index: int, pool) -> None:
    """A memory pool a capture opened: the innermost :func:`holding`
    releases it with its graphs; outside one it lives as long as the
    process."""
    if _holders:
        _holders[-1].pools.append((index, pool))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class captured_launches:
    """``with captured_launches() as got:`` around a graph capture (or a
    part of one): on exit ``got`` holds the launches the wrappers counted
    inside, and :data:`LAUNCHES` is as it was on entry, since a capture
    launches nothing."""

    def __enter__(self) -> dict:
        self._before = dict(LAUNCHES)
        self.counts: dict = {}
        return self.counts

    def __exit__(self, *exc) -> None:
        for name, was in self._before.items():
            self.counts[name] = LAUNCHES[name] - was
            LAUNCHES[name] = was


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``counts`` (from :class:`captured_launches`) ``times`` over: the
    launches of a captured graph's ``times`` replays."""
    for name, n in counts.items():
        LAUNCHES[name] += n * times


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR``, else ``build/repro_torch_kernels`` at the
    root of the checkout (beside ``src/``), else inside the installed
    package."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    pkg = Path(__file__).resolve().parents[1]
    root = pkg.parents[1] if pkg.parent.name == "src" else pkg
    return root / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "on a machine with the CUDA toolkit")
    return found


def _sources() -> tuple[list[Path], str]:
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def _build(out: Path, srcs: list[Path]) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(so),
                               *map(str, objs), *LINK_FLAGS],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(so, out)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built and loaded on first use, with
    every entry point of ``_SIGNATURES`` resolved and typed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            srcs, digest = _sources()
            path = build_dir() / f"librepro_torch_kernels_{digest}.so"
            if not path.is_file():
                _build(path, srcs)
            lib = ctypes.CDLL(str(path))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
                _entries[name] = fn
            _lib = lib
    return _lib


def launch(name: str, index: int, *args) -> None:
    """Calls the C entry point ``name`` with ``args`` and the current
    stream of CUDA device ``index``; raises if it returns an error (a
    launch the runtime refused)."""
    fn = _entries.get(name)
    if fn is None:
        library()
        fn = _entries[name]
    if torch._C._cuda_getDevice() == index:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def workspace(name: str, index: int, nbytes: int) -> torch.Tensor:
    """A zeroed device buffer of at least ``nbytes`` for kernel ``name``,
    which leaves it zeroed again when it ends (a ticket), so no eager call
    pays a memset.

    Eager calls share one buffer per device and stream (two streams never
    share one; calls on one stream run in order).  A grown buffer retires
    the old one but keeps it alive: a CUDA graph captured earlier may still
    replay into it.  A call being captured into a graph gets a buffer of
    its own, zeroed by a node of that graph and kept as long as the graph
    (:func:`keep`), so graphs replayed on different streams never share
    one."""
    device = torch.device("cuda", index)
    if torch.cuda.is_current_stream_capturing():
        buf = torch.zeros((nbytes,), dtype=torch.uint8, device=device)
        keep(buf)
        return buf
    key = (name, index, torch._C._cuda_getCurrentRawStream(index))
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < nbytes:
        if buf is not None:
            _kept.append(buf)
        buf = torch.zeros((nbytes,), dtype=torch.uint8, device=device)
        _workspaces[key] = buf
    return buf


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when all lie on
    the CPU (the plain version's device); raises on anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on one CUDA device or all "
                     f"on the CPU, got {sorted(kinds)}")


def cuda_index(*tensors: torch.Tensor) -> int | None:
    """The index of the CUDA device every tensor lies on, or None when all
    lie on the CPU (the plain version's device); raises on anything else,
    as :func:`on_cuda` does."""
    first = tensors[0]
    if first.is_cuda:
        index = first.get_device()
        for t in tensors:
            if not t.is_cuda or t.get_device() != index:
                break
        else:
            return index
    on_cuda(*tensors)                   # raises unless all lie on the CPU
    return None


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy on a 16-byte boundary (the kernels' vector loads, TMA
    and cp.async copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pow2_ceil(v: int) -> int:
    """The least power of two >= v (v >= 1): launch shapes of the kernels
    templated on one."""
    return 1 << (v - 1).bit_length()


# The storage types of the kernels templated on float32 and bfloat16, by
# the suffix of their C entry points.
FLOAT_KINDS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def float_kind(t: torch.Tensor, name: str) -> str:
    if t.dtype not in FLOAT_KINDS:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return FLOAT_KINDS[t.dtype]


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> None:
    """Validate a kernel operand before its pointer crosses into C."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.shape != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
