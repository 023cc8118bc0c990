"""The port's CUDA graphs: capture, replay and the cache.

The JAX package compiles its programs with ``jax.jit``; this module is
their counterpart, so it has no JAX original.  On a CUDA device
``Layer3SegmentEncoder`` replays the whole segment program as one graph
captured once per key (stage "segment", ``models/layer3.py``), as the
JAX package compiles ``encode_segment_fused`` as one program.  Its
staged form (``encode_segment_staged``), which the corpus path and
``settle``'s retries run, replays three parts (``SEGMENT_STAGES``): the
analysis (one graph), the rate loop (``ops/loop.py``: its prologue, then
its iterations, unrolled, as a second graph of the entry) and, after the
final rate loop, the emission and packing (a third graph of the loop's
entry, one for each continuation).  So do the Layer I/II
analysis (``ops/layer12.py``, one graph a frame count; with psy model 2
a second graph of the same entry, ``run_next``, holds the back half from
the analysis to K6's buffer) and the multi-rank clip's analysis
(``parallel/clip.py``: psy with the automaton's maps, and the spectra,
two graphs around the maps' all-gather).  Each is ``run`` (a key's
first program) and ``run_next`` (the entry's later programs, reading its
static tensors).  ``graph_counts`` counts captures and replays by stage
(``STAGES``).

Every graph of a device is captured into one memory pool and replays on
one stream, one graph at a time (``LOCK``).  So a tensor that a graph
made lives only until the next replay of any graph: what crosses
replays (a program's static inputs and outputs, the loop's state) is
made eagerly, outside the pool, and the caller gets clones.

A graph replays fixed addresses: the tables it reads must be the same
tensors from call to call.  ``shared_tensors`` gives equal tables on one
device one set of tensors, so that every encoder finds the graphs of the
first.
"""
import hashlib
import threading
import time
from collections import OrderedDict
from functools import lru_cache

import numpy as np
import torch

from ..runtime.profiling import scope

#: the captured parts of the Layer III segment program's staged form, by
#: what they count as
SEGMENT_STAGES = ("analysis", "prologue", "iteration", "emission")
#: every captured stage: the segment program as one graph, its staged
#: form's, the Layer I/II analysis and back half, and the multi-rank
#: clip's two analysis graphs
STAGES = ("segment",) + SEGMENT_STAGES + ("l12_analysis", "l12_back",
                                          "sharded_psy", "sharded_spectra")
#: graph captures and replays by stage
graph_counts = {stage: dict(captures=0, replays=0) for stage in STAGES}


def reset_counts():
    for c in graph_counts.values():
        c.update(captures=0, replays=0)


def totals():
    """{"captures": n, "replays": m} summed over the stages."""
    return {k: sum(c[k] for c in graph_counts.values())
            for k in ("captures", "replays")}


def by_stage():
    """{stage: (captures, replays)}: a copy of ``graph_counts``."""
    return {s: (c["captures"], c["replays"]) for s, c in graph_counts.items()}


# ---------------------------------------------------------------------------
# tables shared by content
# ---------------------------------------------------------------------------

def fingerprint(arrays):
    """A digest of a dict of arrays: names, dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[k]))
        h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def canonical_device(device):
    """torch.device with a CUDA index filled in."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


#: shared_tensors' dicts by the arrays' fingerprint and the device
_SHARED = {}


def shared_tensors(arrays, device):
    """Tensors on `device` for a dict of numpy arrays, each of its own
    dtype.  Equal dicts on one device give the same tensors (no code
    writes them), made on first request: a graph keyed by the tables'
    identity then serves every encoder of the same tables."""
    dev = canonical_device(device)
    key = (fingerprint(arrays), str(dev))
    if key not in _SHARED:
        _SHARED.setdefault(key, {k: torch.as_tensor(np.asarray(v),
                                                    device=dev)
                                 for k, v in arrays.items()})
    return dict(_SHARED[key])


def key_of(inputs, *tables):
    """What a captured program is specific to: each input's dtype, shape
    and device (or its absence), and its tables: their Python values and
    the identity of their tensors (which the entry keeps alive)."""
    return (tuple(None if t is None else (t.dtype, tuple(t.shape), t.device)
                  for t in inputs.values()),
            tuple(tuple((k, id(v)) if isinstance(v, torch.Tensor) else (k, v)
                        for k, v in T.items()) for T in tables))


# ---------------------------------------------------------------------------
# the cache and its entries
# ---------------------------------------------------------------------------

class GraphCache:
    """At most `size` entries by key, the least recently used dropped
    first.  An entry (``Captured``) holds every tensor that its graphs
    read, so no graph outlives what it reads."""

    def __init__(self, size):
        self.size = size
        self.entries = OrderedDict()

    def __len__(self):
        return len(self.entries)

    def get(self, key):
        """The entry of `key` (now the most recent), or None."""
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry):
        """Add `entry` as the most recent; returns the entries dropped."""
        self.entries[key] = entry
        self.entries.move_to_end(key)
        dropped = []
        while len(self.entries) > self.size:
            dropped.append(self.entries.popitem(last=False)[1])
        return dropped

    def clear(self):
        self.entries.clear()


# one captured program runs at a time: the entries' static tensors, the
# graph stream and K3's counter are shared
LOCK = threading.Lock()


def _launch_counts():
    """The launch counts of the kernels a graph may hold: K3, bits_at, K4,
    K5 and K6."""
    from . import alloc12, bits_at, pack12, resv, search  # loop imports this
    return (search.launches, bits_at.bits_at.launches, resv.launches,
            alloc12.launches, pack12.launches)


def _add_launches(n_search, n_bits_at, n_resv, n_alloc12, n_pack12):
    from . import alloc12, bits_at, pack12, resv, search
    search.launches += n_search
    bits_at.bits_at.launches += n_bits_at
    resv.launches += n_resv
    alloc12.launches += n_alloc12
    pack12.launches += n_pack12


class Captured:
    """One key's captured program: its static inputs (made by the eager
    warm-up, outside the graphs' memory pool), the static tensors its
    graphs write (`outputs` by graph name), its graphs with the kernel
    launches each holds, their stages and the seconds each capture took,
    and the other objects they read (`refs`: tables, K3's buffers and
    counter, the rate loop's continuations)."""

    def __init__(self, inputs, refs):
        self.inputs, self.refs = inputs, refs
        self.outputs = {}
        self.graphs, self.held, self.stage = {}, {}, {}
        self.capture_s = {}

    def capture(self, name, fn, record, stage):
        """``record(fn)`` as graph `name` of `stage`.  The kernel wrappers
        count a launch as it is made; those made into the graph are taken
        back out of their counts, and added again at each replay."""
        before = _launch_counts()
        t0 = time.perf_counter()
        self.graphs[name] = record(fn)
        self.capture_s[name] = time.perf_counter() - t0
        after = _launch_counts()
        self.held[name] = [a - b for a, b in zip(after, before)]
        _add_launches(*[b - a for a, b in zip(after, before)])
        self.stage[name] = stage
        graph_counts[stage]["captures"] += 1

    def replay(self, name):
        self.graphs[name].replay()
        _add_launches(*self.held[name])
        graph_counts[self.stage[name]]["replays"] += 1


def assign(dst, src):
    """Copy each tensor of `src` into the tensor of `dst` by the same
    name, into nested dicts alike (a captured program's results into its
    static tensors)."""
    for k, v in src.items():
        if isinstance(v, dict):
            assign(dst[k], v)
        elif v is not None and v is not dst[k]:
            dst[k].copy_(v)


def run(cache, key, stage, inputs, fn, record, refs=()):
    """A program captured whole, its host side on the current stream.  On
    first sight of `key` fn runs eagerly on static clones of `inputs`
    (the warm-up: its results, made outside the pool, are this call's
    and become the static outputs) and ``record`` captures fn with its
    results copied into them (CUDA: ``cuda_graph``); otherwise the
    inputs are copied into the static inputs and the graph replays.
    Returns (entry, the entries the cache dropped); ``entry.outputs[stage]``
    holds this call's results until the next call of its key."""
    entry = cache.get(key)
    dropped = []
    if entry is None:
        static = {k: None if v is None else v.clone()
                  for k, v in inputs.items()}
        entry = Captured(static, refs)
        out = entry.outputs[stage] = fn(static)
        entry.capture(stage, lambda: assign(out, fn(static)), record, stage)
        dropped = cache.put(key, entry)
    else:
        for k, t in entry.inputs.items():
            if t is not None:
                t.copy_(inputs[k])
        entry.replay(stage)
    return entry, dropped


def run_next(entry, stage, fn, record, name=None, refs=(), span=None):
    """A later program of `entry` (``run``'s), captured whole as its
    graph `name` (default: `stage`) of `stage`: fn() reads the entry's
    static tensors (and may write them in place) and returns a dict of
    results.  On the entry's first call of `name` fn runs eagerly (the
    warm-up: its results, made outside the pool, become the static
    outputs) and ``record`` captures it with its results copied into
    them, and `refs` join what the entry keeps alive; otherwise the graph
    replays, inside the profiler span `span` if one is given (fn opens
    its own spans where it runs).  Returns ``entry.outputs[name]``, this
    call's results until the next call of the entry."""
    name = stage if name is None else name
    if name in entry.graphs:
        if span is None:
            entry.replay(name)
        else:
            with scope(span):
                entry.replay(name)
    else:
        entry.refs += tuple(refs)
        out = entry.outputs[name] = fn()
        entry.capture(name, lambda: assign(out, fn()), record, stage)
    return entry.outputs[name]


# ---------------------------------------------------------------------------
# CUDA
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def stream(device):
    """The stream on which the captured programs of `device` warm up, are
    captured and replay."""
    return torch.cuda.Stream(device=device)


@lru_cache(maxsize=None)
def pool(device):
    """One memory pool for every graph of `device`: no tensor of the pool
    lives past its graph's run (what crosses replays is in the entries'
    static tensors), and the graphs replay one at a time on one stream,
    so they can share their temporaries."""
    return torch.cuda.graph_pool_handle()


def cuda_graph(device):
    """``record`` for ``run`` and ``run_next`` on `device`: fn()
    captured into a CUDA graph on the graph stream, in the shared pool."""
    def record(fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool(device),
                              stream=stream(device),
                              capture_error_mode="thread_local"):
            fn()
        return graph
    return record


def on_stream(device, body, keep):
    """``body()`` on the graph stream of `device` (which first waits for
    the caller's) under ``LOCK``; body returns (result, the entries a
    cache dropped), and the stream is waited for before those are let
    go.  Then, still under the lock, the caller's stream waits for the
    graph stream and ``keep(result)`` runs on it: what the caller keeps
    of the static tensors, cloned before another replay can write them."""
    caller = torch.cuda.current_stream(device)
    with LOCK:
        s = stream(device)
        s.wait_stream(caller)
        with torch.cuda.stream(s):
            res, dropped = body()
            if dropped:                 # no dropped graph still runs
                s.synchronize()
        caller.wait_stream(s)
        return keep(res)
