"""Spans and counters of the port's own host work, recorded only while a
``torch.profiler`` profile records.

``span(name)`` (a context) and ``traced(name)`` (a decorator: the whole
call) are a ``torch.profiler.record_function`` range on the
profiler's host timeline, the clock of its device events, so a trace puts
each idle gap of the card down to the innermost span of the port that the
host was in.  ``count(name, n)`` adds to a counter of this process, and
``count_read(nbytes)`` counts one blocking read from the device.  With no
profiler recording, a span is one shared no-op context and a count does
nothing: each costs one read of the flag that torch sets while a profile
records (``torch.autograd.profiler._is_profiler_enabled``).

Spans nest on the caller's thread; the enclosing span is the parent.  Span
names start with ``slt.``.  Counters:

  h2d_bytes   bytes of the device tensors made from host arrays
              (``config.to_device``, ``solve_batch``'s B)
  pinned_h2d_bytes  of those, the bytes staged through pinned host memory
              (``parallel/sharded.py::_staged_upload``)
  d2h_bytes   bytes read back from the device (``config.to_host``,
              ``config.host_float``, ``config.host_pair``, ``solve_batch``'s
              B norms, the batch loops' column norms)
  pinned_d2h_bytes  of those, the bytes landed in pinned host memory
              (``config.to_host`` from a CUDA device)
  host_syncs  blocking reads of device data: each of the reads above
  cg_chain_calls  chunks of CG steps run as one ``op.cg_chain`` call
              (``solvers/cg.py::_cg_chain_run``)
  neumann_chain_calls  chains of Neumann steps run as one
              ``op.neumann_chain`` call (``ops/csr_spmv.py::neumann_chain``)
  neumann_chain_steps  the steps of those chains (a replay of a CUDA
              graph counts the chains its capture listed in both:
              ``ops/csr_spmv.py::replayed``)
  neumann_graph_captures  captures of the Neumann solver's CUDA graphs
              (``solvers/neumann.py::_Replay``)
  neumann_graph_chunks    chains that ran inside a replay of those graphs
  pagerank_transition_builds  PageRank calls that built P^T's operator
              and dangling mask (``graph/pagerank.py::_transition_inputs``)
  pagerank_transition_hits    PageRank calls that found them built on
              the adjacency

``utils/profiling.py::device_trace`` resets the counters on entry and
writes them beside its trace.  This module imports only torch, so every
layer of the port can use it.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.autograd import profiler as _profiler

_NO_SPAN = contextlib.nullcontext()
_counters: dict[str, int] = {}
_lock = threading.Lock()


def enabled() -> bool:
    """True while a torch profiler records on this process."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context that records ``name`` as a range while a profiler records,
    else the shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def traced(name: str):
    """Decorator: each call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _profiler._is_profiler_enabled:
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def count_read(nbytes: int) -> None:
    """Count one blocking read of ``nbytes`` from the device: one
    ``host_syncs`` and ``nbytes`` in ``d2h_bytes``."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counters["host_syncs"] = _counters.get("host_syncs", 0) + 1
            _counters["d2h_bytes"] = _counters.get("d2h_bytes", 0) + nbytes


def counters() -> dict:
    """A copy of the counters: {name: total since the last ``reset``}."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()
