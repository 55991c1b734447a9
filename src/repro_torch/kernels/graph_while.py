"""A loop whose exit the device decides: ``lax.while_loop`` for a round
captured into a CUDA graph.

:func:`device_while` runs ``body()`` while ``cond()`` (a 0-dim bool
tensor) holds, testing before the first pass and after each one.  On a
stream that is capturing a CUDA graph it adds a conditional WHILE node to
the graph (``csrc/graph_while.cu``): ``body`` is captured once, from a
stream of its own, into the node's body graph, and each replay runs it as
many times as the data asks, with no host sync.  Anywhere else it is a
host loop with one sync a pass (the flag's read).

A body must keep its loop state in tensors it updates in place: the
captured pass replays on the same addresses.  Its allocations go to a
memory pool of their own, kept with the node's flag and pass counter as
long as the graph may replay: by the graph's owner, which collects them
(:class:`repro_torch.kernels._lib.holding`) and releases them with its
graph, else for the life of the process.

Launch accounting: the kernels a body launches are captured once but run
once a pass.  Each node keeps a device counter of its passes in the
replay; :func:`recording` collects the capture's nodes, each with its
counter and the launches of one pass, for the graph's owner to add up
(:func:`repro_torch.kernels._lib.add_launches`).

The greedy (:mod:`repro_torch.core.dagsa_jit`) takes its loop through
:func:`device_while`, captured or not.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Callable

import torch

from repro_torch.kernels import _lib

_body_streams: dict[int, torch.cuda.Stream] = {}
_recorders: list[list] = []


@contextlib.contextmanager
def recording():
    """Collect the WHILE nodes captured inside: yields a list that fills
    with ``(passes, launches)`` a node, ``passes`` the node's 0-dim int32
    device counter (its passes in the last replay) and ``launches`` the
    kernel launches of one pass."""
    nodes: list = []
    _recorders.append(nodes)
    try:
        yield nodes
    finally:
        _recorders.pop()


def _body_stream(index: int) -> torch.cuda.Stream:
    s = _body_streams.get(index)
    if s is None:
        s = _body_streams[index] = torch.cuda.Stream(device=index)
    return s


def _end_pool(index: int, pool) -> None:
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if end is None:                         # torch before 2.6
        end = torch._C._cuda_endAllocateCurrentStreamToPool
    end(index, pool)


def _host_test(go: torch.Tensor) -> bool:
    """The host loop's read of the flag: its one sync a pass."""
    return bool(go)


def device_while(cond: Callable[[], torch.Tensor],
                 body: Callable[[], None]) -> None:
    """``while cond(): body()``, the test made on the device when the
    current stream is capturing a graph (see the module doc)."""
    go = cond()
    if not (go.is_cuda and torch.cuda.is_current_stream_capturing()):
        while _host_test(go):
            body()
            go = cond()
        return
    index = go.get_device()
    flag = go.to(torch.uint8)                  # what the node's test reads
    passes = torch.zeros((), dtype=torch.int32, device=go.device)
    stream = _body_stream(index)
    handle = ctypes.c_ulonglong()
    _lib.launch("graph_while_begin", index, flag.data_ptr(),
                stream.cuda_stream, ctypes.byref(handle))
    pool = torch.cuda.graph_pool_handle()
    with torch.cuda.stream(stream):
        torch._C._cuda_beginAllocateCurrentStreamToPool(index, pool)
        try:
            with _lib.captured_launches() as per_pass:
                body()
                passes.add_(1)
                flag.copy_(cond())
            _lib.launch("graph_while_end", index, flag.data_ptr(), handle)
        finally:
            _end_pool(index, pool)
    # the node's buffers and pool live as long as the graph may replay
    _lib.keep(flag, passes)
    _lib.keep_pool(index, pool)
    if _recorders:
        _recorders[-1].append((passes, per_pass))
