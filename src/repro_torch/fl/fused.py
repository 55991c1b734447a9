"""The fused round engine: ``FLSimulation.run(mode="fused")`` and
``run(mode="async")`` on the card, and a learning sweep's buckets.

The JAX package runs a whole FL run as one ``lax.scan`` in one jitted
program: no per-round dispatch or host sync, the records crossing to the
host once.  The port's counterpart on the card is one synchronous round
(world, schedule, local SGD, aggregation, eval) captured as a CUDA graph
and replayed once a round:

* The round index is a static 0-dim float32 device tensor, filled before
  each replay (a fill kernel, no host sync); the step reads it where a
  round index reaches the device (the Eq. (8g) floor, the fairness
  monitor).
* What the host decides from the round index (an evaluation round,
  hierarchical aggregation's global sync) picks a graph: one graph a
  pattern, captured the first time the pattern comes up and kept.
* The greedy's loop runs in a conditional WHILE node
  (:func:`repro_torch.kernels.graph_while.device_while`).
* The state is static: the step is functional, and the graph copies its
  new state into the buffers it read, so each replay continues the run.
  Each round's record is packed into one static float64 row (every output
  flattened, its shape kept: 0-dim for an FL round, ``[G]`` for a sweep
  bucket's G cells), copied into a ``[n_rounds, K]`` device buffer after
  the replay; the buffer crosses to the host once, at the end of
  :meth:`FusedRounds.run`.
* Before a pattern's capture the step runs once, eagerly, on a side
  stream over a clone of the state (lazy initialisation stays out of the
  graph); the clone is dropped, so the run does not advance.

* A run hands back a clone of the static state, so parameters a caller
  keeps from one run do not change under the next run's replays.
* :meth:`FusedRounds.release` drops the graphs, the memory pools of the
  graphs and of their device loops' bodies, the buffers the captures kept
  for their replays, and the static state (a sweep releases each
  bucket's before the next).

A failed capture or replay raises; nothing falls back to the host loop.
(On the CPU, asked for explicitly as the tests do, ``FLSimulation`` runs
a fused round as the same step without a graph.)

Launch accounting: a pattern's capture counts the launches outside its
WHILE nodes once (added at each replay) and a node's launches once a pass
(added at the end of the run, from the node's pass counter).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import _lib, graph_while


_warm_streams: dict[int, torch.cuda.Stream] = {}


def _warm_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of every warm-up on ``device``: one for the
    process, so the buffers that libraries keep a stream (cuBLAS's
    workspace, the kernels' eager workspaces) do not pile up a bucket."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    s = _warm_streams.get(index)
    if s is None:
        s = _warm_streams[index] = torch.cuda.Stream(device=index)
    return s


def _flatten(tree) -> list:
    """The tensor leaves of a round state: dataclasses by field, dicts by
    sorted key, tuples and lists by index; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _flatten(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flatten(t)]
    raise TypeError(f"a round state holds no {type(tree).__name__}")


def _rebuild(tree, leaves):
    """``tree``'s structure over ``leaves`` (in :func:`_flatten` order)."""
    it = iter(leaves)

    def go(t):
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: go(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        return type(t)(go(x) for x in t)
    return go(tree)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    launches: dict          # the launches outside the WHILE nodes
    nodes: list             # (pass counter, launches of one pass) a node
    packed: torch.Tensor    # [K] float64: the round's record, then passes


class FusedRounds:
    """Runs a round step as captured CUDA graphs (see the module doc).

    ``step_fn(state, r, r_dev) -> (state', out)`` is the round step of
    :func:`repro_torch.fl.rounds.make_round_step` (or a sweep bucket's
    step over its cells, ``out``'s tensors then ``[G]``); ``pattern(r)``
    the host's branch decisions for round ``r`` (one graph a value), from
    the same :func:`~repro_torch.fl.rounds.make_round_step`."""

    def __init__(self, step_fn: Callable, pattern: Callable[[int], tuple],
                 device: torch.device):
        self._step_fn = step_fn
        self._pattern = pattern
        self.device = device
        self._graphs: dict[tuple, _Graph] = {}
        self._static = None                 # the state the graphs read
        self._static_leaves: list = []
        self._names: list[str] | None = None
        self._dtypes: list = []
        self._shapes: list = []
        self._pool = None
        self._held = _lib.Held()            # what the captures keep
        self._r_dev = None
        self.capture_s = 0.0                # seconds spent in warm-up and
                                            # capture, all patterns
        self.run_s = 0.0                    # seconds spent in run(), the
                                            # captures included
        self.replays = 0

    @property
    def n_graphs(self) -> int:
        return len(self._graphs)

    def launches_outside_loops(self) -> dict:
        """Each pattern's launches outside its WHILE nodes (a replay adds
        these, plus a node's pass launches for each of its passes)."""
        return {str(k): dict(g.launches) for k, g in self._graphs.items()}

    def release(self) -> None:
        """Drop the graphs, their pools (the graphs' and their device
        loops' bodies'), the buffers the captures kept and the static
        state; a later :meth:`run` captures afresh.  The pools' memory
        goes back to the card at the next ``torch.cuda.empty_cache``."""
        if self._graphs:
            torch.cuda.synchronize(self.device)
        for g in self._graphs.values():
            g.graph.reset()
        self._graphs.clear()
        self._held.release()
        self._static, self._static_leaves = None, []
        self._names, self._dtypes, self._shapes = None, [], []
        self._pool = self._r_dev = None

    # ------------------------------------------------------------ run --
    def run(self, state, r0: int, n_rounds: int):
        """``n_rounds`` rounds from ``state`` at round index ``r0``:
        ``(state', records)``, ``state'`` a clone of the static state and
        records a dict of ``[n_rounds, *shape]`` numpy arrays, an output's
        shape in the step (``greedy_steps``: the WHILE nodes' passes a
        round, summed), copied to the host once."""
        t0 = time.perf_counter()
        self._adopt(state)
        rec = None
        for i, r in enumerate(range(r0, r0 + n_rounds)):
            g = self._graph_for(r)
            self._r_dev.fill_(float(r))
            g.graph.replay()
            _lib.add_launches(g.launches)
            self.replays += 1
            if rec is None:
                rec = torch.empty((n_rounds, g.packed.shape[0]),
                                  dtype=torch.float64, device=self.device)
            rec[i].copy_(g.packed)
        host = rec.cpu().numpy()                    # the one host copy
        cols, k = {}, 0
        for name, dt, shape in zip(self._names, self._dtypes, self._shapes):
            size = math.prod(shape)
            cols[name] = host[:, k:k + size].reshape(
                (n_rounds,) + shape).astype(dt)
            k += size
        passes = host[:, k:]
        for (_, per_pass), col in zip(self._node_layout(), passes.T):
            _lib.add_launches(per_pass, int(col.sum()))
        if passes.shape[1]:
            cols["greedy_steps"] = passes.sum(axis=1).astype(np.int64)
        self.run_s += time.perf_counter() - t0
        return _rebuild(self._static,
                        [t.clone() for t in self._static_leaves]), cols

    def _node_layout(self) -> list:
        layouts = {len(g.nodes) for g in self._graphs.values()}
        if len(layouts) != 1:
            raise RuntimeError("the round's graphs hold different numbers "
                               "of device loops")
        return next(iter(self._graphs.values())).nodes

    # -------------------------------------------------------- capture --
    def _adopt(self, state) -> None:
        """Make ``state`` the static state: on the first run, clones with
        storage of their own (the policies' state shares one zero tensor
        at start); later, a copy into the static buffers."""
        if self._static is None:
            self._static_leaves = [t.clone() for t in _flatten(state)]
            self._static = _rebuild(state, self._static_leaves)
            self._r_dev = torch.zeros((), dtype=torch.float32,
                                      device=self.device)
            self._pool = torch.cuda.graph_pool_handle()
        else:
            for dst, src in zip(self._static_leaves, _flatten(state)):
                dst.copy_(src)

    def _graph_for(self, r: int) -> _Graph:
        key = self._pattern(r)
        g = self._graphs.get(key)
        if g is None:
            t0 = time.perf_counter()
            self._warm_up(r)
            g = self._capture(r)
            torch.cuda.synchronize(self.device)
            self.capture_s += time.perf_counter() - t0
            self._graphs[key] = g
        return g

    def _warm_up(self, r: int) -> None:
        """One eager step over a clone of the state, on a side stream; its
        launches are not counted and its state is dropped."""
        side = _warm_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), _lib.captured_launches():
            clone = _rebuild(self._static,
                             [t.clone() for t in self._static_leaves])
            r_dev = self._r_dev.clone().fill_(float(r))
            self._step_fn(clone, r, r_dev)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)

    def _capture(self, r: int) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        own = {t.untyped_storage().data_ptr(): i
               for i, t in enumerate(self._static_leaves)}
        with _lib.holding(self._held), \
                _lib.captured_launches() as launches, \
                graph_while.recording() as nodes:
            with torch.cuda.graph(graph, pool=self._pool):
                new_state, out = self._step_fn(self._static, r, self._r_dev)
                new = _flatten(new_state)
                # a new leaf that shares another static leaf's storage is
                # read before that leaf is overwritten
                new = [t.clone() if own.get(t.untyped_storage().data_ptr(),
                                            i) != i else t
                       for i, t in enumerate(new)]
                for dst, src in zip(self._static_leaves, new):
                    dst.copy_(src)
                names = sorted(out)
                packed = torch.cat(
                    [out[k].reshape(-1).to(torch.float64) for k in names]
                    + [p.reshape(-1).to(torch.float64) for p, _ in nodes])
        shapes = [tuple(out[k].shape) for k in names]
        if self._names is None:
            self._names, self._shapes = names, shapes
            self._dtypes = [np.dtype(str(out[k].dtype).split(".")[-1])
                            for k in names]
        elif names != self._names or shapes != self._shapes:
            raise RuntimeError("the round's graphs record different fields")
        return _Graph(graph=graph, launches=launches, nodes=list(nodes),
                      packed=packed)
