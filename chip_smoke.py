#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mp3tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--parent-tree DIR]

Phases, each printing its own lines; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build the five kernel libraries, K1 (mp3tpu_torch/csrc/hist_c1.cu),
     bits_at with K3 (csrc/bits_at.cu), K4 (csrc/resv_scan.cu), K5
     (csrc/alloc12.cu) and K6 (csrc/pack12.cu), all but
     K1 with -Xptxas -v, whose reports are printed, one nvcc process
     each, started together; timed;
  3. K1 against its plain PyTorch version on the card, bit for bit, on
     random quantized batches at G = 512, 4096 (the main path's segment
     widths) and 4099, then both timed: device time per call from
     torch.profiler, and call time with CUDA events (median);
  3b. bits_at, the rate loop's whole bit evaluation in one launch,
     against its plain chain (bits_at_plain), torch.equal on every
     output: random batches of long, short and start/stop granules at
     G = 512, 4096 and 4099 (about a quarter past IXMAX) and at 16384
     and 65536 (how its time scales with the batch), one with
     MPEG-2 LSF 22.05 kHz tables, one wholly past IXMAX, and the main
     path's own first 4096-lane evaluation (the first stepsize of its
     first 4096-lane stepsize search, captured at the search's entry) at
     six stepsizes; timed (kernel device and call time, the plain chain's
     device time, K1's device time on the same quantized batch) beside
     the bound;
  3c. K3, the stepsize searches in one launch each, at the width (warps
     a granule) its launch picks and at widths 1, 2, 3, 4 and 7, against
     the lockstep plain searches on bits_at: torch.equal on qss, bits,
     every count row and
     the evaluation counts, status 0: random stepsize and walk batches at
     G = 512, 4096, 4099, 16384 and 65536, LSF batches, a qss_lo batch,
     a walk and a stepsize batch driven into the 40-step cap, and the
     main path's own first 4096- and 512-lane stepsize searches and
     walks; timed: K3's device time at the picked width and at each
     width, its call time, the evaluations the plain schedule counts
     against those K3 runs, the plain search's device time, call time
     and bits_at launches, beside the bound (the larger of the bytes' and
     the operations' time) and K3's share of it;
  3d. K4, the reservoir scan (the chunk maps, then their composition and
     the re-walk: two kernels a call), against its plain version (the
     native host scan): torch.equal on every budget and carried level,
     on the main path's own four scans (captured at resv.scan_budgets'
     entry), on random batches (padded holes in one row and in a row a
     clip, resv_max 0, LSF, odd mean_bits, 1 to 32 clips) and on edge
     cases (size0 off the domain behind a leading padded run, holes
     across chunk boundaries, resv_max 7 and 8, one frame, forced chunks
     of 1, 2, 7, F and F + 1 frames, a negative size0 or delta); timed on
     the main path's 512- and 4096-lane segments and a corpus group of 16
     (device time with each kernel's share, call time, the host scan it
     replaced with its download and upload), beside the bound and the
     design's floor, and at forced chunks; with --parent-tree DIR (a
     checkout of the parent commit) the parent's K4 in turns with this
     one on the same inputs;
  4. the 15 quality fixtures of tests/test_fast_encoder.py through the
     quality tool (mp3tpu_torch.tools.quality, encode_layer3_fast on
     "cuda"): frame grid and the reference encoder's decoded-SNR bars
     (in-repo decoder), and libmpg123's best-lag SNR when it is present;
  5. the main path: the 60 s stereo 44.1 kHz 128 kbps clip of bench.py
     (its signal, copied here), encoded six ways: with loop's searches
     swapped (by this script) for the lockstep plain searches and
     loop._bits_at for the plain chain, then for the chain of K1 with
     plain PyTorch around it, then the plain searches on bits_at (the
     lockstep path), then K3 with the rate loop op by op (its
     evaluation counts recorded), each of
     these in the segment program's staged form (tools.staged_form) with
     loop.outer_loop_eager (a replayed graph calls no Python), then as the
     package runs it (K3, the segment program as one CUDA graph a
     segment), each with the launch counts reset before and read after
     (each swap must show in them); the five streams must be equal byte for
     byte, the iterations counted equal op by op and in the graph (which
     launches K3 in all 6 unrolled iterations of both rate loops and reads
     no exit on the host; 56 K3 and 4 K4 launches an encode), and K3's
     evaluation counts must give the lockstep path's bits_at launches;
     then 3 warm encodes timed before torch's GPU trace is turned on and
     3 after (it stays on: what its callbacks cost), and the host's waits
     of one warm encode by kind (loop exit, scan copy, fetch) against
     torch's own count of synchronizing operations
     (mp3tpu_torch.tools.host_waits: torch.cuda.set_sync_debug_mode's
     warnings and the GPU trace's event, stream and device
     synchronizations): 0, 0 and 1.
     Then the lockstep path and the package in 5 ABBA turns (10 timed runs
     each), one encode of each under torch.profiler (device kernels,
     copies and memsets by category, device idle share), and K3's
     device time summed over one encode, in two windows; the stream must
     sit on the frame grid and its
     first 10 s must decode within 1 dB of the CPU path's 10 s encode;
  5b. the rate loop as CUDA graphs (loop.outer_loop on the card: the
     prologue and 6 iterations unrolled, one replay each) against the
     rate loop op by op (loop.outer_loop_eager) on the main path, the
     analysis and
     the emission in their yardstick forms in both
     (mp3tpu_torch.tools.yardstick_form): captures from an
     empty cache (capture time per key, torch.cuda.memory_reserved before
     and after), captures, replays, loop-exit syncs and K3 launches of
     both, the iterations of each outer_loop call, the same bytes, 3 ABBA
     turns (real-time factor), one profiled encode each (device events,
     idle share) and one traced encode each (host dispatches -- kernel
     and graph launches, copies, memsets -- and device events inside the
     outer_loop spans; search_kernel events = search.launches); then
     outer_loop == outer_loop_eager (torch.equal on every output) on the
     main path's own first 512- and 4096-lane demand and final batches
     and on random MPEG-1 and LSF demand and final batches at G = 4096
     and 32,768, each new key called twice (its capture, then replays);
  5c. the segment program as the package runs it on the card, one CUDA
     graph a segment (the analysis of all lanes in one batch, the demand
     rate loop, K4, the final budgets, the final rate loop and the
     emission and packing in one replay, n_real an input of the graph,
     one wait an encode), against its staged form (tools.staged_form: the
     analysis, rate-loop and emission graphs with K4 and the budgets
     between them) and the yardstick form (the staged form with the
     analysis lane by lane and the emission op by op): captures from
     empty caches (the plan's 4 segments on 2 keys; capture ms,
     torch.cuda.memory_allocated and memory_reserved growth by key);
     each of the main path's segment calls as one graph against
     encode_segment_staged, torch.equal on every output, two calls each;
     the caller's clones timed (all outputs against what the fetch and
     the carry need);
     the staged form's graphs from empty caches: the captured analysis
     against the lane-by-lane one, torch.equal on every output, on the
     main path's own 512- and 4096-lane segments, two calls each, and
     each product of the analysis batched alone (which change an
     output); encode_final with the emission replayed against
     encode_final_eager on the main path's own final encodes; then the
     three forms: the same bytes, counts (launches, waits, captures and
     replays by stage), 3 turns of yardstick, staged, graphs, graphs,
     staged, yardstick (real-time factor), one profiled encode each
     (device events, idle share) and one traced encode each (host
     dispatches and device events by span: the package at most 30 host
     dispatches a segment, none of the inner spans firing; the staged
     form's analyze_demand_fused at most 100 of its own, granule_payload
     at most 32); each held graph replayed from an idle card (the
     launch's host time against the whole, replay_timing); a warm encode
     under cProfile, which must call graphs.fingerprint no time;
  6. MPEG-2 LSF: the three 0.5 s mono cases of tests/test_lsf.py, then a
     60 s stereo 24 kHz 64 kbps clip (launches and waits counted), interior
     frames on the grid, the yardstick form's bytes, each segment as one
     graph == encode_segment_staged on every output, first 10 s within
     1 dB of the CPU path;
  7. streaming: the bench clip in 1 s pieces through StreamEncoder at
     window 1024 (launches counted, timed) must equal the one-shot
     encode at chunk 1024 byte for byte, and the stream in the yardstick
     form, and so must a run checkpointed at 30 s, pickled and resumed in
     a fresh encoder; each window as one graph == encode_segment_staged
     on every output; one wait a window;
  8. Layers I/II, one chain queued on the card (int16 PCM uploaded as
     int16, the analysis replaying one CUDA graph a frame count, K5 --
     the joint decision and the greedy bit allocation, one warp a frame,
     each greedy step's argmin as ordered keys reduced with redux.sync --,
     the quantizers, the element marshalling, K6 -- each frame packed
     with its CRC, one block a frame --, one download): the captured
     analysis (layer12.analyze_frames) against its op-by-op form
     (analyze_frames_eager), torch.equal on every output, on every
     fixture and cell, a capture call and a replay each (capture ms by
     key, torch.cuda.memory_reserved before and after); the six fixtures
     of tests/test_layer12_fast.py at their reference bars and the two
     CRC fixtures decoding, each equal byte for byte to the yardstick
     form (tools.yardstick_form: the analysis and the back half op by
     op; the card chain replays both as graphs of one key) and to the
     host back half (the card's analysis, then K5's, the quantizers' and
     K6's plain versions and the marshalling on the CPU); K5 against its
     plain version (runtime/alloc12's numpy code) on every output and
     its greedy steps against the lockstep loop's rounds, on the CRC
     fixtures', the
     bench signal's and the forced rows of
     tests/test_torch_layer12_card.py (ties, +-inf, NaN, silent frames,
     every subband to its top, Layer I's limit); K6 against its plain
     version on every byte; K5's -Xptxas -v lines (no stack frame, no
     spill) and the blocks it holds on an SM with the waves of each
     cell; then on the 60 s bench signal at Layer II 192 kbps and Layer
     I 384 kbps stereo: K5 and K6 launched once each, no Layer III kernel,
     K5 timed (device time in three windows, call time), K6 timed (device
     time, call time), each beside the plain
     version's time and its bound (K5: the largest of its bytes, its
     design's dependent path a step times the longest frame's steps, and
     the warp instructions of every frame's steps at the SMs' rates,
     k5_bound, printed by term; K6: its bytes), the yardstick form and
     the card chain in 3 turns of yardstick, card, card, yardstick (walls,
     real-time factor; the bytes the host back half's), one
     profiled encode of each (device events, idle share), one traced
     encode of each (span_breakdown by runtime.profiling.SPANS_L12; the
     card chain's analyze_frames span under 20 host dispatches, its one
     _layer12_back span holding one K5 and one K6 event under 8 host
     dispatches of its own; the yardstick's K5 and K6 under
     greedy_allocation and pack_elements), the key's capture seconds by
     graph, and the host's waits by torch's count: 1 an encode, one a
     window of encode_layer12_stream, whose warm windows replay their
     analysis and back-half graphs and capture none; the same bytes as
     the host back half and the yardstick form at joint
     stereo with the CRC on at both layers, at stereo with the CRC, and
     at 24 kHz (LSF); psy model 1 (on the host) with 2 waits; the Layer
     II stream on the frame grid, its first 10 s within 0.5 dB of the
     CPU path;
  9. the command line: python -m mp3tpu_torch on a 10 s WAV and on raw
     PCM piped to stdin must write the library's bytes (the WAV's: the
     yardstick form's too);
  10. corpus: 32 stereo 44.1 kHz 128 kbps clips x 10 s (bench_corpus.py's
     clips) through encode_corpus_batched at lane batch 1, 2, 4, 8 and 16
     by the corpus sweep tool (mp3tpu_torch.tools.corpus_sweep.sweep): one
     warm-up and 3 timed runs each (aggregate real-time factor, K3
     launches per group, equal outputs, frame grid); the captured graphs
     then held (capture ms, torch.cuda.memory_reserved); one group of 1
     and one of 16 split into analysis, rate loop with emission and the
     rest (wall between synchronizes, device kernels by stage); the whole
     corpus at lane batch 16 as the package runs it against the
     yardstick form as in 5c (the same bytes for every clip, the sweep's);
     the captured analysis against the lane-by-lane one on a group's 32
     lanes as in 5c; the eight stereo 44.1 kHz
     128 kbps quality fixtures as one mixed-length group, each at its bar
     and within 0.5 dB of its one-shot encode; K3 (each width) against
     the plain search on the first 32,768-lane stepsize
     search of a group of 16, timed as in phase 3c, and bits_at against
     its plain chain at its first stepsize, timed; one wait a group;
     the group lookahead (encode_corpus_batched(lookahead=)) at 0 (the
     groups in order) and 3 (the default) on bench_corpus's 20 clips at
     lane batch 2 and on the 32 at lane batch 16: every clip's bytes the
     sweep's, one wait a group, torch.cuda.max_memory_allocated of a run,
     3 turns of 0, 3, 3, 0 (median wall, aggregate real-time factor) and
     one profiled run of each (device events, idle share);

  11. multi-device: dryrun_multichip(1) on an NCCL mesh, then the 60 s
     clip through encode_layer3_sharded at world size 1 (NCCL, this
     process) and 2 (gloo, two processes of this script run with
     --sharded-rank, both computing on cuda:0): equal length, equal block
     types and first-10 s SNR within 0.5 dB of the one-shot encode at the
     same chunk, both ranks' bytes equal, each run's bytes those of its
     yardstick form (the analysis lane by lane); timed, kernels counted,
     the analysis's two graphs (psy with the automaton's maps, the
     spectra) and the rate loop's replayed, the host scan kept; the
     host's waits of a warm encode against torch's count (world 1:
     waits_check, one scan download and one fetch; world 2: each rank's
     counters, gloo exchanges included); K3
     against the plain search on each run's own first stepsize search
     (9,216 lanes at world size 1, 4,608 on each rank at 2) and bits_at
     against its plain chain at three stepsizes of that batch;
  12. tooling: runtime.profiling.trace around one 60 s bench encode into
     a temporary directory (trace.json parses, every named program span
     of runtime.profiling.SPANS is in it but those whose programs a
     replayed graph covers (runtime.profiling.REPLAY_COVERS), its
     search_kernel and
     bits_at_kernel events equal search.launches and bits_at.launches of
     that encode, and K4's resv_map_kernel and resv_walk_kernel events
     number one or two a K4 call, the same bytes as phase 5; its device
     events by category (kernels, copies, memsets) as span_breakdown reads them
     from trace.json must equal tools.device_events of the same window,
     beside the copy calls with no device event; per span
     its count, host wall and the device events launched inside it), the
     trace_stages and profile_encode tools on the 60 s clip (their JSON
     printed), and libmpg123 on the 60 s main-path, LSF and Layer II
     streams (rate, channels, length; its best-lag SNR over the clip and
     over the first 10 s, against the in-repo decoder's on the first 10 s
     and the two decoders' agreement);
  13. the benchmark tools (mp3tpu_torch.tools.bench and bench_corpus, the
     port's bench.py and bench_corpus.py): in this process bench.run on
     the 60 s clip (its timed stream must be phase 5's) and
     bench_corpus.run on 20 clips x 10 s at lane batch 2 and its group
     lookahead of 3, which is printed (each stream on
     the frame grid and equal to phase 10's at lane batch 2: the same
     groups of two); then each tool with its defaults in 3 fresh
     processes from an empty temporary directory, each JSON line
     printed, and per tool the three values with their median, min and
     max beside the card's name and power limit; with --parent-tree DIR
     the parent's tools as well, in turns parent, this, this, parent;
  14. encode_corpus with 3 worker threads from empty graph caches on a
     mixed corpus (stereo 128 kbps clips of several lengths at 44.1 and
     48 kHz, so that threads capture several keys at once): every stream
     equal to its own encode_layer3_fast and to the yardstick form's, the
     wall against one worker.
On every path (main, LSF, stream, corpus, sharded) K3 must launch, the
segment program's CUDA graphs must replay (on the main, LSF and stream
paths the one graph and no graph of the staged form; on the corpus path
the analysis, the rate loop and the emission; the sharded path's
analysis as its two graphs around the exchange between ranks, then the
rate loop and the emission), and none may launch bits_at, K5 or K6;
every path
but the
sharded one (which keeps its host scan, as the JAX package does) must
launch K4 and make no loop-exit sync and no scan copy; the launches,
the host's waits by kind and graph captures and replays by stage per
path are printed.
Its last lines are a JSON object describing the kernels and then
{"ok": true, "device": {...}}.  It imports nothing of JAX and nothing of
the JAX package.
"""
import contextlib
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from mp3tpu_torch.tools import (DEVICE_CATS,  # noqa: E402
                                FP32_OPS_PER_S, HBM_BYTES_PER_S,
                                device_events, gpu_trace_on, host_waits,
                                profile_once, staged_form, yardstick_form)
from mp3tpu_torch.tools.signals import make_signal  # noqa: E402

CLIP_SECONDS = 60.0
TIMED_RUNS = 3
#: phase 5 times the lockstep path and K3 in this many ABBA turns (2 runs each)
TURNS = 5
#: the widths (warps a granule) at which phase 3c checks and times K3
WIDTHS = (1, 2, 3, 4, 7)
#: NVIDIA H100 SXM: 64 int32 lanes an SM on 132 SMs at the 1.98 GHz boost
#: clock (the float32 rate of mp3tpu_torch.tools counts 128 lanes and an
#: FMA as two)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: the operations that one K3 evaluation cannot avoid (csrc/bits_at.cu
#: evaluate), by the lines that need them.  Every line of the 576:
#: float32, the quantizer's multiply, subtract, add and floor and its
#: clamp's max and min, 6; int32, the conversion and the running largest
#: value, 2.  A line of the big_values region (2 * big_values lines), int32:
#: the pair's class (two mins and a multiply-add a pair: 1.5), its region
#: (two compares a pair: 1), the three LUT lookups (an address and a load
#: each a pair: 3) and the three candidate sums (an add each a pair: 1.5),
#: 7.  A count1 quad, int32: its index from four values (four mins, three
#: shift-adds), the count1 length's address and load, its sum, and the
#: sign count's popc and sum, 12.
K3_FP32_OPS_LINE, K3_INT32_OPS_LINE = 6, 2
K3_INT32_OPS_PAIR_LINE, K3_INT32_OPS_QUAD = 7, 12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes, ops):
    """The least milliseconds an H100 could take: the larger of the
    bytes over the HBM rate and the operations over the float32 rate;
    returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def call_ms(fn, reps=50):
    """Median milliseconds of one fn() call as a caller sees it on the
    card: CUDA events around the call, host-side overhead included."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=20, tries=3):
    """Mean device milliseconds per fn() call: the summed time of the
    kernels it runs, read from torch.profiler.  The profiler now and
    then records no device event in a window; it is asked up to `tries`
    times (None if it never recorded device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA)
        if us > 0:
            return us / 1000.0 / reps
    return None


def events_by_cat(events):
    """{category: count} of tools.device_events' list."""
    return {c: sum(e[0] == c for e in events) for c in DEVICE_CATS}


def kernel_events(fn, names, tries=3):
    """One fn() under torch.profiler's CUDA activity: {name: (events, device
    ms)} of the device events whose name holds each of `names` (asked up to
    `tries` times while the profiler records no device event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
        if device:
            break
    return {n: (sum(n in e.name for e in device),
                sum(e.time_range.elapsed_us() for e in device
                    if n in e.name) / 1e3) for n in names}


def kernel_series(fns, names, reps=20, tries=3):
    """One torch.profiler window over `reps` calls of each fn in turn, each
    call launching one kernel whose name holds the fn's entry of `names`:
    the mean device milliseconds of each fn's launches, split by launch
    order.  A window that misses or misplaces an event is asked again, up
    to `tries` times (None if every window did).  One window for many
    timings: the profiler loses more events the more windows a process
    opens."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if getattr(e, "device_type", None) == DeviceType.CUDA
                         and any(n in e.name for n in names)),
                        key=lambda e: e.time_range.start)
        blocks = [events[i * reps:(i + 1) * reps] for i in range(len(fns))]
        if len(events) == reps * len(fns) and all(
                name in e.name for name, b in zip(names, blocks) for e in b):
            return [sum(e.time_range.elapsed_us() for e in b) / reps / 1e3
                    for b in blocks]
    return None


def queued_ms(fn, reps=20, tries=4):
    """Mean device milliseconds per fn() call from CUDA events around
    `reps` calls queued behind a sleeping kernel: the card starts the
    first call only once the host has queued the last, so the events read
    the calls back to back on the card (the gaps between kernels
    included), not the host's launch time.  The sleep grows until the
    queue was full before it ended (None if it never was).  The fallback
    where torch.profiler loses events."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 10_000_000
    for _ in range(tries):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        full = not a.query()
        b.synchronize()
        if full:
            return a.elapsed_time(b) / reps
        cycles *= 4
    return None


def k1_bound(args, G):
    """K1's bound: ixp, the four per-granule ints and is_short, the LUT
    and count1 lengths read once; bits_tab (G, 3, 32), mx (G, 3), b0raw
    and signs written once; 32 table sums per pair (9,216 adds a
    granule) as operations."""
    from mp3tpu_torch.ops import hist_c1 as k1
    ixp, a1, a2, bv, c1, short, _ = args
    lut, hlen = k1._device_tables(ixp.device)
    out = G * (3 * 32 + 3 + 1 + 1) * 4
    return bound(nbytes(ixp, a1, a2, bv, c1, short, lut, hlen) + out,
                 288 * 32 * G)


def phase_kernel(k1, torch):
    """K1 vs its plain version at the main path's widths; returns
    {G: (max_abs_err, kernel_ms, plain_ms, (bound_ms, bound_by))}."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_hist_c1_card import kernel_args, random_batch
    results = {}
    for G in (512, 4096, 4099):
        args = kernel_args(*random_batch(2024 + G, G), "cuda")
        got = k1.hist_c1(*args)
        torch.cuda.synchronize()
        want = k1.hist_c1_plain(*args)
        err = max(float((a.to(torch.float64) - b.to(torch.float64))
                        .abs().max()) for a, b in zip(got, want))
        for name, a, b in zip(("bits_tab", "mx", "c1_b0raw", "c1_signs"),
                              got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"K1 != plain at G={G} in {name}")
        k_call = call_ms(lambda: k1.hist_c1(*args))
        p_call = call_ms(lambda: k1.hist_c1_plain(*args))
        k_dev = device_ms(lambda: k1.hist_c1(*args))
        p_dev = device_ms(lambda: k1.hist_c1_plain(*args))
        print(f"K1 hist_c1 G={G}: equal to plain (max_abs_err {err}); "
              f"device time per call (torch.profiler): kernel {k_dev} ms, "
              f"plain {p_dev} ms; call time (CUDA events, median of 50): "
              f"kernel {k_call:.4f} ms, plain {p_call:.4f} ms", flush=True)
        if k_dev is None or p_dev is None:
            k_dev, p_dev = k_call, p_call
            print("  (no profiler device time: the JSON reports call times)",
                  flush=True)
        b_ms, b_by = k1_bound(args, G)
        print(f"  bound {b_ms:.6f} ms ({b_by}); kernel at "
              f"{b_ms / k_dev:.1%} of it", flush=True)
        results[G] = (err, k_dev, p_dev, (b_ms, b_by))
    # MPEG-2 LSF (22.05 kHz): its long-block sfb table moves the region
    # addresses
    from mp3tpu_torch.tables import mpeg
    args = kernel_args(*random_batch(22050, 4096), "cuda", mpeg.MPEG2_LSF)
    got = k1.hist_c1(*args)
    torch.cuda.synchronize()
    want = k1.hist_c1_plain(*args)
    for name, a, b in zip(("bits_tab", "mx", "c1_b0raw", "c1_signs"),
                          got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"K1 != plain on the LSF batch in {name}")
    print("K1 hist_c1 G=4096 MPEG-2 LSF 22.05 kHz tables: equal to plain",
          flush=True)
    return results


def bits_at_bound(args):
    """bits_at's bound: xr75p, qss, the two block flags, the per-rate
    table pack, the LUT and count1 lengths read once; 12 int32 rows per
    granule written once; 3 float32 operations a line (scale, offset,
    round) as operations."""
    from mp3tpu_torch.ops import bits_at as K
    xr75p, qss, short, sblk, ST = args
    lut, hlen = K._device_tables(xr75p.device)
    G = xr75p.shape[0]
    return bound(nbytes(xr75p, qss, short, sblk, ST["bits_at_tab"], lut, hlen)
                 + len(K.ROWS) * G * 4, 3 * 576 * G)


def capture_searches(ctx, run, lanes, what):
    """The first stepsize search and the first walk of `lanes` granules
    that run() makes, recorded by wrapping loop.search_stepsize and
    loop.search_walk (whose callers look them up at each call), with the
    segment program in stages (tools.staged_form) and the rate loop run by
    loop.outer_loop_eager (a replayed graph calls no Python):
    {"stepsize": (args, kwargs), "walk": (args, kwargs)}, tensors
    cloned."""
    loop = ctx["loop"]
    real = {"stepsize": loop.search_stepsize, "walk": loop.search_walk,
            "outer_loop": loop.outer_loop}
    seen = {}

    def recorder(kind):
        def record(*args, **kwargs):
            if kind not in seen and args[0].shape[0] == lanes:
                seen[kind] = (tuple(a.clone() if hasattr(a, "clone") else a
                                    for a in args),
                              {k: v if v is None else v.clone()
                               for k, v in kwargs.items()})
            return real[kind](*args, **kwargs)
        return record

    loop.search_stepsize = recorder("stepsize")
    loop.search_walk = recorder("walk")
    loop.outer_loop = loop.outer_loop_eager
    try:
        with staged_form():
            run()
    finally:
        loop.search_stepsize = real["stepsize"]
        loop.search_walk = real["walk"]
        loop.outer_loop = real["outer_loop"]
    for kind in ("stepsize", "walk"):
        if kind not in seen:
            fail(f"the {what} made no {lanes}-lane {kind} search")
    return seen


def first_evaluation(captured):
    """bits_at's arguments at the first stepsize a captured stepsize search
    evaluates: the first mid of its bisection (its first bit evaluation,
    the batch this script captured before the searches were one kernel)."""
    import torch
    (xr75p, budget, qanf, short, sblk, ST), kwargs = captured
    from mp3tpu_torch.ops import loop
    lo = torch.clamp(qanf, min=loop.QMIN)
    if kwargs.get("qss_lo") is not None:
        lo = torch.maximum(lo, kwargs["qss_lo"])
    mid = torch.floor((lo + loop.QMAX) * 0.5)
    return xr75p, mid, short, sblk, ST


def path_batch_check(ctx, run, lanes, what):
    """On the first `lanes`-lane stepsize search that run() makes: K3
    against the plain search, and bits_at against bits_at_plain at its
    first stepsize -60, +0 and +8.  Returns (the stepsize search's
    captured (args, kwargs), bits_at's max abs error, K3's)."""
    seen = capture_searches(ctx, run, lanes, what)
    s_errs, errs = [], []
    search_check(ctx, f"{what} stepsize search", "stepsize",
                 *seen["stepsize"], s_errs)
    xr75p, qss, short, sblk, ST = first_evaluation(seen["stepsize"])
    for d in (-60.0, 0.0, 8.0):
        bits_at_check(ctx, f"{what} batch at qss{d:+.0f}",
                      (xr75p, qss + d, short, sblk, ST), errs)
    return seen["stepsize"], max(errs), max(s_errs)


def capture_main_searches(ctx, pcm, cfg):
    """The main path's first stepsize search and walk of each segment
    width: {4096: captured, 512: captured}."""
    return {lanes: capture_searches(
        ctx, lambda: ctx["encode"](pcm, cfg, device="cuda"), lanes,
        "main path") for lanes in (4096, 512)}


def bits_at_check(ctx, label, args, errs):
    """bits_at against bits_at_plain on every output (fails on any
    difference); appends the max abs error to errs; returns the plain
    chain's outputs."""
    torch, loop = ctx["torch"], ctx["loop"]
    from mp3tpu_torch.ops import bits_at as K
    from test_torch_bits_at_card import mismatches
    got = K.bits_at(*args)
    torch.cuda.synchronize()
    want = K.bits_at_plain(*args)
    bad = mismatches(got, want)
    if bad:
        fail(f"bits_at != plain on {label} in {bad}")
    errs.append(max(float((got[k].to(torch.float64)
                           - want[k].to(torch.float64)).abs().max())
                    for k in want))
    over = int((want["ix_max"] > loop.IXMAX).sum())
    short = int(args[2].sum())
    sblk = int((args[3] & ~args[2]).sum())
    print(f"bits_at {label}: every output equal to plain (G="
          f"{args[0].shape[0]}: {short} short, {sblk} start/stop, "
          f"{over} past IXMAX)", flush=True)
    return want


def bits_at_timed(ctx, label, args):
    """Kernel device and call time, the plain chain's device time, and
    K1's device time on the same quantized batch."""
    k1, loop = ctx["k1"], ctx["loop"]
    from mp3tpu_torch.ops import bits_at as K
    xr75p, qss, short, sblk, ST = args
    ixp = loop.quantize_pow75(xr75p, qss)
    count1, bv = loop.calc_runlen(ixp, short)
    _, _, a1, a2 = loop.subdivide(bv, short, sblk, ST)
    k1_args = (ixp, a1, a2, bv, count1, short, ST["r0_pairs_short"])
    k_dev = device_ms(lambda: K.bits_at(*args))
    k_call = call_ms(lambda: K.bits_at(*args))
    p_dev = device_ms(lambda: K.bits_at_plain(*args))
    k1_dev = device_ms(lambda: k1.hist_c1(*k1_args))
    if k_dev is None or p_dev is None:
        k_dev = k_call
        p_dev = call_ms(lambda: K.bits_at_plain(*args))
        print("  (no profiler device time: kernel and plain chain "
              "report call times)", flush=True)
    b_ms, b_by = bits_at_bound(args)
    print(f"bits_at {label} timed: device time per call (torch.profiler, "
          f"mean of 20): kernel {k_dev} ms, plain chain {p_dev} ms, K1 "
          f"alone on the same quantized batch {k1_dev} ms; kernel call "
          f"time (CUDA events, median of 50) {k_call:.4f} ms; bound "
          f"{b_ms:.6f} ms ({b_by}), kernel at {b_ms / k_dev:.1%} of it",
          flush=True)
    return k_dev, p_dev, k1_dev, b_ms, b_by


def phase_bits_at(ctx, main_args):
    """Phase 3b: bits_at against bits_at_plain on the card; returns the
    JSON fields measured on the main path's own 4096-lane batch."""
    loop, mpeg = ctx["loop"], ctx["mpeg"]
    from test_torch_bits_at_card import kernel_args, random_batch
    errs = []

    def check(label, args):
        return bits_at_check(ctx, label, args, errs)

    # the main path's widths, then wider batches (a corpus batches clips
    # as extra lanes): one granule a warp at G = 4096 fills one wave
    for G in (512, 4096, 4099, 16384, 65536):
        args = kernel_args(*random_batch(3030 + G, G), "cuda")
        check(f"random G={G}", args)
        bits_at_timed(ctx, f"random G={G}", args)
    lsf = kernel_args(*random_batch(22050, 4096), "cuda", mpeg.MPEG2_LSF)
    check("random G=4096, MPEG-2 LSF 22.05 kHz tables", lsf)
    xr75, qss, is_short, wsf = random_batch(7, 4096)
    xr75[:, 0] = 1e6
    import numpy as np
    over = kernel_args(xr75, np.full_like(qss, -40.0), is_short, wsf, "cuda")
    if not bool((check("G=4096 all past IXMAX", over)["bits"] == 1e9).all()):
        fail("bits_at: a granule past IXMAX did not get 1e9 bits")

    xr75p, qss, short, sblk, ST = main_args
    n_over = 0
    for d in (-60.0, -8.0, -4.0, 0.0, 4.0, 8.0):
        want = check(f"main path's batch at qss{d:+.0f}",
                     (xr75p, qss + d, short, sblk, ST))
        n_over += int((want["ix_max"] > loop.IXMAX).sum())
    if n_over == 0:
        fail("no stepsize of the main path's batch went past IXMAX")
    k_dev, p_dev, k1_dev, b_ms, b_by = bits_at_timed(ctx, "main path's batch",
                                                     main_args)
    return dict(max_abs_err=max(errs), ms=k_dev, plain_ms=p_dev,
                k1_ms=k1_dev, bound_ms=b_ms, bound_by=b_by)


def search_fns(kind):
    """(K3's wrapper, the lockstep plain search) of a search kind."""
    from mp3tpu_torch.ops import loop, search
    if kind == "stepsize":
        return search.search_stepsize, loop.search_stepsize_plain
    return search.search_walk, loop.search_walk_plain


def search_err(got, want):
    """The largest absolute difference of two search results over qss,
    bits and the plain search's count rows."""
    import torch
    pairs = [(got[0], want[0]), (got[1], want[1])] + [
        (got[2][k], v) for k, v in want[2].items()]
    return max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
               if a.numel() else 0.0 for a, b in pairs)


def search_check(ctx, label, kind, args, kwargs, errs):
    """K3 at the width its launch picks and at each width of WIDTHS
    against the lockstep plain search (on bits_at): torch.equal on qss,
    bits, every count row and the evaluation counts, and status 0
    everywhere; appends K3's max abs error (at the picked width) to errs;
    returns K3's result at the picked width."""
    import torch
    from mp3tpu_torch.ops import search
    from test_torch_search_card import search_mismatches
    kernel, plain = search_fns(kind)
    G = args[0].shape[0]
    got = {"the picked width": kernel(*args, **kwargs)}
    for w in WIDTHS:
        got[f"width {w}"] = kernel(*args, **kwargs, width=w)
    torch.cuda.synchronize()
    want = plain(*args, **kwargs)
    for how, res in got.items():
        bad = search_mismatches(res, want)
        if bad:
            fail(f"K3 at {how} != the plain {kind} search on {label} in "
                 f"{bad}")
        if bool(res[2]["status"].any()):
            fail(f"K3 at {how} on {label}: a stepsize missed the istep75 "
                 f"table")
    res = got["the picked width"]
    errs.append(search_err(res, want))
    evals = res[2]["evals"]
    cap = 42 if kind == "walk" else 53
    runs = {w: int(got[f"width {w}"][2]["runs"].sum()) for w in WIDTHS}
    pick = search.plan(G)["width"] if G else 1
    print(f"K3 {kind} search {label}: equal to the plain search on every "
          f"output, status 0, at the picked width {pick} and at widths "
          f"{', '.join(map(str, WIDTHS))} (G={G}: "
          f"evaluations per granule {int(evals.min())}-{int(evals.max())}, "
          f"{int(evals.sum())} in all, {int((evals == cap).sum())} at the "
          f"40-step cap; {int((res[1] == 1e9).sum())} left past IXMAX); "
          f"evaluations run by width {runs}", flush=True)
    return res


def serial_work(kind, args, kwargs, n_bisect=8, max_steps=40):
    """K3's schedule at width 1 (csrc/bits_at.cu search_kernel with one warp
    a granule; tests/test_torch_search_card.py model_granule on the CPU)
    replayed over the batch, one bits_at launch a pass: the stepsizes whose
    outcome the plain search reads, each evaluated once.  Returns (G,)
    tensors: qss, runs (the evaluations), pair_lines (2 * big_values summed
    over them: the lines of their big_values regions) and quads (count1
    summed over them)."""
    import torch
    from mp3tpu_torch.ops import bits_at as K
    from mp3tpu_torch.ops import loop
    xr75p, budget, start, short, sblk, ST = args
    G, dev = xr75p.shape[0], xr75p.device
    BISECT, WALK, DOWN, DONE = 0, 1, 2, 3

    def full(v, dtype=torch.float32):
        return torch.full((G,), v, dtype=dtype, device=dev)

    qss = start.clone()
    floor_q, lo, hi, below = (full(loop.QMIN), full(loop.QMIN),
                              full(loop.QMAX), full(0.0))
    lo_known, hi_known, below_known = (full(False, torch.bool)
                                       for _ in range(3))
    left, steps, first, down, runs, pair_lines, quads = (
        full(0, torch.int64) for _ in range(7))
    phase = full(WALK, torch.int64)
    if kind == "stepsize":
        floor_q = torch.maximum(qss, floor_q)        # NaN as nan_max keeps it
        lo = floor_q
        if kwargs.get("qss_lo") is not None:
            lo = torch.maximum(floor_q, kwargs["qss_lo"])
        left = full(n_bisect, torch.int64)
        phase = full(BISECT, torch.int64)
    for _ in range(n_bisect + max_steps + 8):
        # a bisection with no step left hands hi on without an evaluation;
        # a down rung known not to fit ends the search
        end = (phase == BISECT) & (left == 0)
        qss = torch.where(end, hi, qss)
        phase = torch.where(end, torch.where(hi_known, DOWN, WALK), phase)
        mid = torch.floor((lo + hi) * 0.5)
        q_down = qss - 1.0
        known_miss = ~(q_down >= floor_q) | (below_known & (q_down == below)) \
            | (lo_known & (q_down == lo))
        phase = torch.where((phase == DOWN) & known_miss, DONE, phase)
        if not bool((phase != DONE).any()):
            break
        bis, walk_, dn = phase == BISECT, phase == WALK, phase == DOWN
        mid_lo, mid_hi = lo_known & (mid == lo), hi_known & (mid == hi)
        q = torch.where(bis, mid, torch.where(walk_, qss + first, q_down))
        active = walk_ | dn | (bis & ~mid_lo & ~mid_hi)
        c = K.bits_at(xr75p, torch.where(active, q, 0.0), short, sblk, ST)
        fits = c["bits"] <= budget
        runs += active
        pair_lines += torch.where(active, 2 * c["big_values"], 0)
        quads += torch.where(active, c["count1"], 0)
        # the bisection: a mid equal to a known bound takes its outcome
        ok = torch.where(mid_lo, False, torch.where(mid_hi, True, fits))
        hi = torch.where(bis & ok, mid, hi)
        lo = torch.where(bis & ~ok, mid, lo)
        hi_known |= bis & ok
        lo_known |= bis & ~ok
        left = left - bis.long()
        # the walk: one rung up from the second on, until it fits or caps
        up = walk_ & (first == 1)
        below = torch.where(up, qss, below)
        below_known |= up
        qss = torch.where(walk_, q, qss)
        steps = steps + torch.where(walk_, first, 0)
        first = torch.where(walk_, 1, first)
        w_end = walk_ & (fits | (steps >= max_steps))
        # the down steps: keep a rung that fits, end at the first miss
        qss = torch.where(dn & fits, q_down, qss)
        down = down + (dn & fits).long()
        d_end = dn & (~fits | (down == 3))
        phase = torch.where(w_end, DONE if kind == "walk" else DOWN, phase)
        phase = torch.where(d_end, DONE, phase)
    else:
        fail(f"the width-1 replay of a {kind} search did not end")
    return dict(qss=qss, runs=runs, pair_lines=pair_lines, quads=quads)


def search_bound(args, kwargs, work):
    """K3's bound, the larger of two times.  Bytes: xr75p, the per-granule
    scalars, the rate tables, the LUT, the count1 lengths and the istep75
    table read once, 16 int32 rows a granule written once, over the HBM
    rate.  Operations: the evaluations the search needs (`work`, from
    serial_work: once each stepsize whose outcome the plain search reads),
    K3_FP32_OPS_LINE float32 operations a line over the float32 rate and
    the int32 operations that each evaluation's lines need
    (K3_INT32_OPS_LINE on all 576, K3_INT32_OPS_PAIR_LINE on the lines of
    its big_values region, K3_INT32_OPS_QUAD a count1 quad) over the
    int32 rate, the two pipes side by side.  Returns (ms, "bytes" or
    "operations", the bytes' ms, the operations' ms)."""
    from mp3tpu_torch.ops import bits_at as K
    from mp3tpu_torch.ops import search
    xr75p, budget, start, short, sblk, ST = args
    lut, hlen = K._device_tables(xr75p.device)
    extra = [v for v in kwargs.values() if v is not None]
    G = xr75p.shape[0]
    rows = len(K.ROWS) + len(search.EXTRA_ROWS)
    b_ms = 1e3 * (nbytes(xr75p, budget, start, short, sblk, ST["bits_at_tab"],
                         lut, hlen, search._istep_table(xr75p.device), *extra)
                  + rows * G * 4) / HBM_BYTES_PER_S
    lines = 576 * int(work["runs"].sum())
    int32_ops = (K3_INT32_OPS_LINE * lines
                 + K3_INT32_OPS_PAIR_LINE * int(work["pair_lines"].sum())
                 + K3_INT32_OPS_QUAD * int(work["quads"].sum()))
    o_ms = 1e3 * max(K3_FP32_OPS_LINE * lines / FP32_OPS_PER_S,
                     int32_ops / INT32_OPS_PER_S)
    if b_ms >= o_ms:
        return b_ms, "bytes", b_ms, o_ms
    return o_ms, "operations", b_ms, o_ms


def search_timed(ctx, label, kind, args, kwargs, plain_too=False):
    """K3 at the width its launch picks, twice, then at each width of
    WIDTHS (device time per call from torch.profiler, a mean of 20 a
    turn, in one window); its call time; the evaluations the plain
    schedule counts against those K3 runs; the bound and K3's share of
    it.  With plain_too also the lockstep plain search on bits_at (the
    lockstep path): its device time, call time and bits_at launches."""
    K = ctx["K"]
    from mp3tpu_torch.ops import search
    kernel, plain = search_fns(kind)
    G = args[0].shape[0]
    pick = search.plan(G)["width"]

    def k3(width=None):
        return lambda: kernel(*args, **kwargs, width=width)

    fns = [k3(), k3()] + [k3(w) for w in WIDTHS]
    ms = kernel_series(fns, ["search_kernel("] * len(fns))
    # the repeated launches left K3's granule counter at zero and gave the
    # checked results
    import torch
    from test_torch_search_card import search_mismatches
    again = kernel(*args, **kwargs)
    if search_mismatches(again, plain(*args, **kwargs)) or bool(
            search._counter(args[0].device).any()):
        fail(f"K3 on {label}: a timed launch left other results or a "
             f"granule counter off zero")
    k_call = call_ms(k3())
    note = ""
    if ms is None:
        ms = [queued_ms(fn) for fn in fns]
        note = (" (torch.profiler lost events: CUDA events around 20 calls "
                "queued behind a sleep)")
        if None in ms[:2]:
            ms = [k_call, k_call] + [None] * len(WIDTHS)
            note = " (no device time: call times)"
    turns = ms[:2]
    by_width = dict(zip(WIDTHS, ms[2:]))
    k_dev = statistics.mean(turns)
    evals = kernel(*args, **kwargs)[2]["evals"]
    runs = {w: kernel(*args, **kwargs, width=w) for w in sorted({1, pick})}
    work = serial_work(kind, args, kwargs)
    one = runs[1]
    if not (bool(((work["qss"] == one[0])
                  | (work["qss"].isnan() & one[0].isnan())).all())
            and torch.equal(work["runs"].int(), one[2]["runs"])):
        fail(f"K3 on {label}: the width-1 replay of its schedule ran other "
             f"stepsizes than K3 at width 1")
    runs = {w: r[2]["runs"] for w, r in runs.items()}
    b_ms, b_by, bytes_ms, ops_ms = search_bound(args, kwargs, work)
    res = dict(ms=k_dev, call_ms=k_call, turns=turns, by_width=by_width,
               width=pick, evals=int(evals.sum()),
               runs={w: int(r.sum()) for w, r in runs.items()},
               bound_ms=b_ms, bound_by=b_by, bytes_ms=bytes_ms,
               ops_ms=ops_ms, work={k: int(work[k].sum()) for k in
                                    ("runs", "pair_lines", "quads")})
    line = (f"K3 {kind} search {label} timed: G={G}, width {pick} picked; "
            f"device time per call (torch.profiler, the kernel's own events, "
            f"mean of 20 a turn; K3 twice, then by width, in one "
            f"window){note}: K3 {' / '.join(str(t) for t in turns)} ms; by "
            f"width (ms): {by_width}; call time (CUDA events, median of "
            f"50): {k_call:.4f} ms; evaluations: {res['evals']} as the plain "
            f"schedule counts them, run {res['runs']} by width; bound "
            f"{b_ms:.6f} ms ({b_by}; bytes {bytes_ms:.6f} ms, operations "
            f"{ops_ms:.6f} ms over the width-1 schedule's {res['work']}): K3 "
            f"at {b_ms / k_dev:.1%} of it")
    if plain_too:
        p_dev = device_ms(lambda: plain(*args, **kwargs))
        p_call = call_ms(lambda: plain(*args, **kwargs), reps=20)
        before = K.bits_at.launches
        plain(*args, **kwargs)
        res.update(plain_ms=p_dev if p_dev is not None else p_call,
                   plain_call_ms=p_call,
                   plain_launches=K.bits_at.launches - before)
        line += (f"; the plain search on bits_at: device {p_dev} ms, call "
                 f"{p_call:.4f} ms ({res['plain_launches']} bits_at "
                 f"launches)")
    print(line, flush=True)
    return res


def phase_search(ctx, main_searches):
    """Phase 3c: K3 against the lockstep plain searches on the card, and
    timed; returns the fields measured on the main path's own first
    4096-lane stepsize search, and the main path's four captured
    searches' measurements under "main"."""
    from test_torch_search_card import case_args, search_case
    errs = []
    # the main path's searches first: the profiler's windows after the
    # widest batches have lost events
    main = {}
    for lanes in (4096, 512):
        for kind in ("walk", "stepsize"):
            args, kwargs = main_searches[lanes][kind]
            label = f"main path's first {lanes}-lane {kind} search"
            search_check(ctx, label, kind, args, kwargs, errs)
            main[(lanes, kind)] = search_timed(ctx, label, kind, args,
                                               kwargs, plain_too=True)
    for G in (512, 4096, 4099, 16384, 65536):
        for name in ("stepsize", "walk"):
            kind, args, kwargs = case_args(search_case(name, G, 6060 + G),
                                           "cuda")
            search_check(ctx, f"random G={G}", kind, args, kwargs, errs)
            search_timed(ctx, f"random G={G}", kind, args, kwargs,
                         plain_too=name == "stepsize")
    for name in ("stepsize_lsf", "walk_lsf", "stepsize_qss_lo", "walk_cap",
                 "stepsize_cap"):
        kind, args, kwargs = case_args(search_case(name, 4096, 22050),
                                       "cuda")
        got = search_check(ctx, f"{name} G=4096", kind, args, kwargs, errs)
        cap = {"walk_cap": 42, "stepsize_cap": 53}.get(name)
        if cap and not int((got[2]["evals"] == cap).sum()):
            fail(f"the {name} case put no granule at the 40-step cap")
        search_timed(ctx, f"{name} G=4096", kind, args, kwargs)
    return dict(main[(4096, "stepsize")], max_abs_err=max(errs), main=main)


#: NVIDIA H100 SXM, data sheet: float64 outside the tensor cores
FP64_OPS_PER_S = 34e12
#: phase 3d's random K4 batches: seed, clips, frames, nch, mode_gr,
#: mean_bits, resv_max, the valid flags (None: every frame real; "holes":
#: one row for every clip; "rows": a row a clip)
K4_CASES = [(0, 1, 1024, 2, 2, 3344, 4088, "holes"),
            (1, 1, 3000, 1, 1, 1080, 2040, "holes"),
            (2, 3, 431, 2, 2, 3081, 4088, "rows"),
            (3, 16, 431, 2, 2, 3344, 4088, None),
            (4, 32, 431, 2, 2, 3344, 4088, None),
            (5, 4, 300, 2, 2, 3080, 0, "holes"),
            (6, 2, 500, 2, 1, 1331, 2040, "rows")]
#: phase 3d's edge cases of the chunked design: seed, frames, nch,
#: mode_gr, mean_bits, resv_max, delta, the clips' size0 (one clip each),
#: the kinds of their valid rows (tests/test_torch_resv_card.py
#: valid_flags: a leading padded run over several chunks, holes across the
#: chunk boundaries, every frame padded, random holes), the chunk (None:
#: the wrapper's pick): size0 off the domain (not a multiple of 8, above
#: resv_max), LSF, resv_max 7 and 8, one frame, chunks of 1, 2, 7, F and
#: F + 1 frames, a negative size0 or delta (the composing thread's own
#: walks)
K4_EDGES = [
    (10, 1024, 2, 2, 3344, 4088, 28, (203, 5000, 0), ("lead", "lead",
                                                        "straddle"), None),
    (11, 431, 1, 1, 1080, 2040, 28, (203, 96), ("lead", "straddle"), None),
    (12, 200, 2, 2, 3080, 7, 28, (0, 5), ("holes", "straddle"), None),
    (13, 200, 2, 2, 3081, 8, 28, (8, 203), ("straddle", "lead"), None),
    (14, 1, 2, 2, 3080, 4088, 28, (203, 0), ("lead", "all"), None),
    (15, 100, 2, 2, 3080, 4088, 28, (5000,), ("none",), None),
    (16, 150, 2, 2, 3344, 4088, 28, (2000, 203), ("holes", "lead"), 1),
    (17, 150, 2, 2, 3344, 4088, 28, (2000, 203), ("straddle", "lead"), 2),
    (18, 150, 2, 2, 3344, 4088, 28, (2000, 203), ("straddle", "lead"), 7),
    (19, 150, 2, 2, 3344, 4088, 28, (2000, 203), ("holes", "lead"), 150),
    (20, 150, 2, 2, 3344, 4088, 28, (2000, 203), ("holes", "lead"), 151),
    (21, 120, 2, 2, 3080, 4088, 28, (-100000,), ("holes",), 3),
    (22, 120, 2, 2, 3080, 4088, -40, (96,), ("holes",), None)]
#: the chunks (frames) at which phase 3d times K4 besides its pick
K4_CHUNKS = (2, 4, 7, 10, 16, 24, 32)
#: K4's kernels (csrc/resv_scan.cu): the map build, then the composition
#: and re-walk; PR 11's one-thread scan, the parent tree's
K4_KERNELS = ("resv_map_kernel", "resv_walk_kernel")
K4_PARENT_KERNEL = "resv_scan_kernel"
#: a checkout of the parent commit (python3 chip_smoke.py --parent-tree
#: DIR): phase 3d then times its K4 in turns with this tree's
PARENT_TREE = None


def capture_scans(ctx, run):
    """Every resv.scan_budgets call that run() makes in the staged form
    (tools.staged_form: encode_segment_staged looks it up at each call; a
    replayed graph calls no Python), recorded at the function's entry:
    [(args, kwargs)], tensors cloned."""
    R = ctx["R"]
    real, seen = R.scan_budgets, []

    def record(*args, **kwargs):
        seen.append((tuple(a.clone() if hasattr(a, "clone") else a
                           for a in args),
                     {k: v.clone() if hasattr(v, "clone") else v
                      for k, v in kwargs.items()}))
        return real(*args, **kwargs)

    R.scan_budgets = record
    try:
        with staged_form():
            run()
    finally:
        R.scan_budgets = real
    return seen


#: the int32 operations of one granule step of the carry (the granule's
#: budget and the level's update, csrc/resv_scan.cu budget_of and
#: level_after), which every design does at least once a granule
K4_OPS_GRANULE = 14
#: the dependent int32 operations on the reservoir level's path through
#: one granule of csrc/resv_scan.cu's walks, counted from below: the
#: multiply of 6*size, the three of the division by 10 (a high multiply,
#: a shift and the sign's add), the min with more_bits, the subtraction of
#: over, its max with 0, the two adds into the budget, the min with 4095,
#: the compare with the demand, the select of used, its max with 0 and the
#: level's update; and per frame, the odd-mean add, the clamp to resv_max,
#: the rounding to a multiple of 8 and the padded frame's select
K4_CHAIN_OPS_GRANULE, K4_CHAIN_OPS_FRAME = 13, 4
#: cycles from one dependent integer operation to the next on an SM: the
#: fixed-latency pipe's 4 of Volta and later (Jia et al., "Dissecting the
#: NVIDIA Volta GPU Architecture via Microbenchmarking", 2018); not
#: measured on the card
INT_LATENCY_CYCLES = 4
#: cycles of one step of the composition: a dependent shared-memory load
#: (19 cycles on Volta, the same paper) and the compare and select that
#: take the next state; not measured on the card
K4_LOOKUP_CYCLES = 19 + 2 * INT_LATENCY_CYCLES
#: the H100 SXM's boost clock, the fastest an SM walks the chain
SM_CLOCK_HZ = 1.98e9
#: the H100 SXM's SMs
H100_SMS = 132


def k4_floor(R, pe, resv_max, chunk):
    """The floor of K4's design (csrc/resv_scan.cu) on (B, F, R) inputs at
    `chunk` frames a chunk, in ms: the larger of (a) its own operations --
    the map build's granule steps (the first chunk from one state, the
    others but the last from each of the S + 1) and the re-walk's, each
    K4_OPS_GRANULE int32 operations, at the card's peak int32 rate -- and
    (b) its critical path -- a map-build walk and a re-walk of C*R
    granules and C frames of dependent operations, INT_LATENCY_CYCLES
    each, and the composition's K - 1 lookups, K4_LOOKUP_CYCLES each, at
    the boost clock.  Returns (floor, operations' time, path's time)."""
    B, F, Rg = pe.shape
    K = max(1, -(-F // chunk))
    steps = B * Rg * F
    walks = 1
    if K > 1:
        steps += B * Rg * chunk * (1 + (K - 2) * R.states(resv_max))
        walks = 2
    ops_ms = steps * K4_OPS_GRANULE / INT32_OPS_PER_S * 1e3
    frames = min(chunk, F)
    cycles = walks * frames * (Rg * K4_CHAIN_OPS_GRANULE
                               + K4_CHAIN_OPS_FRAME) * INT_LATENCY_CYCLES \
        + (K - 1) * K4_LOOKUP_CYCLES
    path_ms = cycles / SM_CLOCK_HZ * 1e3
    return max(ops_ms, path_ms), ops_ms, path_ms


def k4_bound(pe, demand, valid, size0):
    """K4's bound: pe, demand, the valid flags and the levels read once,
    the budgets and levels written once; per granule two float64
    operations (the multiply and the subtraction of more_bits) and one
    granule step (K4_OPS_GRANULE int32 operations) as operations at the
    card's peak rates.  A bound of any design: k4_floor is that of the
    chunked design."""
    n = pe.numel()
    moved = nbytes(pe, demand, size0) + (0 if valid is None
                                          else nbytes(valid)) \
        + 4 * n + 4 * size0.numel()
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = 2 * n / FP64_OPS_PER_S + K4_OPS_GRANULE * n / INT32_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def k4_check(ctx, label, pe, demand, valid, size0, args, chunk=None):
    """K4 (resv._launch, at `chunk` or its pick) against the host scan
    (resv's plain form) on (B, F, R) device tensors, torch.equal on every
    budget and level; returns the max abs error (0)."""
    torch, R = ctx["torch"], ctx["R"]
    got_b, got_s = R._launch(pe, demand, valid, size0, *args, _chunk=chunk)
    torch.cuda.synchronize()
    want_b, want_s = [], []
    for b in range(pe.shape[0]):
        v = None if valid is None else (valid if valid.dim() == 1
                                        else valid[b]).cpu()
        wb, ws = R.scan_budgets(pe[b].cpu(), demand[b].cpu(),
                                int(size0[b]), *args, valid=v)
        want_b.append(wb)
        want_s.append(ws)
    want_b, want_s = torch.stack(want_b), torch.stack(want_s)
    err = max(int((got_b.cpu() - want_b).abs().max()) if want_b.numel()
              else 0, int((got_s.cpu() - want_s).abs().max()))
    if not (torch.equal(got_b.cpu(), want_b)
            and torch.equal(got_s.cpu(), want_s)):
        fail(f"K4 != the host scan on {label} (max abs error {err})")
    return err


def k4_series(calls, reps=20, tries=3):
    """One torch.profiler window over `reps` calls of each fn of `calls`
    [(fn, names)] in turn, each call launching one kernel of each of its
    `names`, in order: [{name: mean device ms a call}] a fn.  A window
    that misses or misplaces an event is asked again, up to `tries` times
    (None if every window did)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    every = {n for _, names in calls for n in names}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn, _ in calls:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if getattr(e, "device_type", None) == DeviceType.CUDA
                         and any(n in e.name for n in every)),
                        key=lambda e: e.time_range.start)
        want = [n for _, names in calls for _ in range(reps) for n in names]
        if len(events) != len(want) or not all(
                n in e.name for n, e in zip(want, events)):
            continue
        out, it = [], iter(events)
        for _, names in calls:
            ms = dict.fromkeys(names, 0.0)
            for _ in range(reps):
                for n in names:
                    ms[n] += next(it).time_range.elapsed_us() / 1e3
            out.append({n: v / reps for n, v in ms.items()})
        return out
    return None


def k4_kernels(F, chunk):
    """The kernels one K4 call launches at `chunk` frames a chunk."""
    return K4_KERNELS if F > chunk else K4_KERNELS[1:]


def parent_library(R):
    """The parent tree's K4 (PR 11's resv_scan_kernel, one thread a clip)
    built from its csrc/resv_scan.cu into build/, loaded with ctypes; None
    without --parent-tree, or when the parent's source is this tree's
    (there is no other K4 to time)."""
    import ctypes
    if PARENT_TREE is None:
        return None
    from mp3tpu_torch.ops import cuda_build
    src = os.path.join(PARENT_TREE, "mp3tpu_torch", "csrc", "resv_scan.cu")
    with open(src, "rb") as f, open(R.SOURCE, "rb") as g:
        if f.read() == g.read():
            print("K4: the parent tree's csrc/resv_scan.cu is this tree's; "
                  "no parent K4 is timed", flush=True)
            return None
    lib_path = os.path.join(cuda_build.BUILD_DIR, "libresv_scan_parent.so")
    cuda_build.build(src, lib_path, R.NVCC_FLAGS, True)
    lib = ctypes.CDLL(lib_path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mp3_resv_scan.restype = i32
    lib.mp3_resv_scan.argtypes = [ptr, ptr, ptr, i32, ptr] + [i32] * 7 + \
        [ptr] * 3
    return lib


def parent_k4(ctx, lib, pe, demand, valid, size0, args):
    """The parent's K4 on the same inputs: (budgets, size_out)."""
    torch = ctx["torch"]
    B, F, Rg = pe.shape
    bud = torch.empty((B, F, Rg), dtype=torch.int32, device=pe.device)
    size = torch.empty(B, dtype=torch.int32, device=pe.device)
    stride = 0 if valid is None or valid.dim() == 1 else F
    mean_bits, resv_max, mode_gr, nch, delta = args
    err = lib.mp3_resv_scan(
        pe.data_ptr(), demand.data_ptr(),
        None if valid is None else valid.data_ptr(), stride,
        size0.data_ptr(), B, F, nch, mode_gr, mean_bits, resv_max, delta,
        bud.data_ptr(), size.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"the parent's K4 failed to launch: CUDA error {err}")
    return bud, size


def k4_timed(ctx, label, pe, demand, valid, size0, args, parent=None):
    """K4's device time a call (both kernels' events summed; torch.profiler
    over 20 calls, else CUDA events behind a sleep), each kernel's share,
    its call time, the host scan's wall on the same device tensors
    (download, the plain scan on the CPU, upload: the path K4 replaced),
    the bound and the design's floor; at forced chunks (K4_CHUNKS); and
    with `parent` (the parent tree's library) its K4 and this one in
    turns, parent, this, this, parent; all in one profiler window.
    Printed, and returned as a dict."""
    torch, R = ctx["torch"], ctx["R"]
    dev = pe.device
    B, F, Rg = pe.shape
    resv_max = args[1]
    chunk = R.chunk_frames(B, F, Rg, resv_max)

    def k4(c=None):
        return lambda: R._launch(pe, demand, valid, size0, *args, _chunk=c)

    def host():
        for b in range(pe.shape[0]):
            v = None if valid is None else (valid if valid.dim() == 1
                                            else valid[b]).cpu()
            bud, size = R.scan_budgets(pe[b].cpu(), demand[b].cpu(),
                                       int(size0[b]), *args, valid=v)
            bud.to(dev), size.to(dev)

    names = k4_kernels(F, chunk)
    chunks = [c for c in K4_CHUNKS if c < F and c != chunk
              and 2 * R.map_words(F, c, resv_max) <= R.MAP_SMEM_BYTES]
    calls = [(k4(), names)] + [(k4(c), k4_kernels(F, c)) for c in chunks]
    if parent is not None:
        def old():
            return parent_k4(ctx, parent, pe, demand, valid, size0, args)
        got, want = old(), k4()()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                              want[1])):
            fail(f"the parent's K4 != this K4 on {label}")
        calls += [(old, (K4_PARENT_KERNEL,)), (k4(), names), (k4(), names),
                  (old, (K4_PARENT_KERNEL,))]
    for fn, _ in calls:
        fn()
    # one profiler window for every timing of this input (the profiler
    # loses more events the more windows a process opens); else CUDA
    # events around each fn's calls queued behind a sleep
    series = k4_series(calls)
    if series:
        how = "torch.profiler, kernels' device time summed"
        ms = [sum(r.values()) for r in series]
        by_kernel = series[0]
    else:
        how = "CUDA events behind a sleep, the kernels' gaps included"
        ms = [queued_ms(fn) for fn, _ in calls]
        by_kernel = None
        if None in ms:
            fail(f"K4 on {label}: neither the profiler nor CUDA events "
                 f"timed it")
    dev_ms = ms[0]
    c_ms = call_ms(k4())
    host()
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    p_ms = statistics.median(walls)
    b_ms, b_by = k4_bound(pe, demand, valid, size0)
    f_ms, f_ops, f_path = k4_floor(R, pe, resv_max, chunk)
    K = max(1, -(-F // chunk))
    shares = "not split" if by_kernel is None \
        else ", ".join(f"{n} {v:.4f} ms ({v / dev_ms:.1%})"
                       for n, v in by_kernel.items())
    print(f"K4 on {label} ({B} clips x {F} frames x {Rg} granules, chunk "
          f"{chunk} frames, {K} chunks, {len(names)} kernels a call): device "
          f"{dev_ms:.4f} ms a call ({how}; {shares}), "
          f"{dev_ms * 1e6 / (F * Rg):.2f} ns a granule of a clip; call "
          f"{c_ms:.4f} ms; the host scan with its download and upload "
          f"{p_ms:.4f} ms (host clock, median of 10); bound {b_ms:.6f} ms "
          f"({b_by}), K4 at {b_ms / dev_ms:.4%} of it; the design's floor "
          f"{f_ms:.6f} ms (its operations {f_ops:.6f} ms: "
          f"{K4_OPS_GRANULE} int32 a granule step at the peak int32 rate; "
          f"its critical path {f_path:.6f} ms: {K4_CHAIN_OPS_GRANULE} "
          f"dependent operations a granule and {K4_CHAIN_OPS_FRAME} a frame "
          f"at {INT_LATENCY_CYCLES} cycles, {K4_LOOKUP_CYCLES} cycles a "
          f"lookup, at {SM_CLOCK_HZ / 1e9} GHz), K4 at {f_ms / dev_ms:.2%} "
          f"of it", flush=True)
    out = dict(ms=dev_ms, call_ms=c_ms, plain_ms=p_ms, bound_ms=b_ms,
               bound_by=b_by, floor_ms=f_ms, floor_ops_ms=f_ops,
               floor_path_ms=f_path, chunk=chunk, chunks=K,
               kernel_ms=by_kernel, ns_per_granule=dev_ms * 1e6 / (F * Rg))
    out["ms_by_chunk"] = dict(zip(map(str, [chunk] + chunks),
                                  ms[:1 + len(chunks)]))
    print(f"K4 on {label} by chunk (frames: device ms a call, the pick "
          f"{chunk}): {out['ms_by_chunk']}", flush=True)
    if parent is not None:
        old_ms = [ms[-4], ms[-1]]
        new_ms = ms[-3:-1]
        out["parent_ms"] = statistics.mean(old_ms)
        out["turns_ms"] = {"parent": old_ms, "this": new_ms}
        print(f"K4 on {label} in turns with the parent's (parent, this, "
              f"this, parent; 20 calls each, device ms a call): parent "
              f"{old_ms[0]:.4f} / {old_ms[1]:.4f}, this {new_ms[0]:.4f} / "
              f"{new_ms[1]:.4f}: this at "
              f"{statistics.mean(new_ms) / out['parent_ms']:.4f} of the "
              f"parent's", flush=True)
    return out


def phase_resv(ctx, pcm, cfg):
    """Phase 3d: K4 against the host scan on the main path's own scans, on
    K4_CASES and on K4_EDGES, and timed on the main path's 512- and
    4096-lane segments and on a corpus group of 16 (with the parent's K4
    in turns, given --parent-tree); returns the 4096-lane timing with the
    largest error."""
    np, torch, R = ctx["np"], ctx["torch"], ctx["R"]
    from test_torch_resv_card import valid_flags
    seen = capture_scans(ctx, lambda: ctx["encode"](pcm, cfg,
                                                   device="cuda"))
    if len(seen) != 4:
        fail(f"the main path made {len(seen)} scans, expected 4")
    errs, main = [], {}
    for i, (a, kw) in enumerate(seen):
        pe, demand = a[0][None].contiguous(), a[1][None].contiguous()
        size0 = R._level(a[2], pe.device, 1)
        args, valid = a[3:], kw.get("valid")
        lanes = pe.shape[1] * pe.shape[2]
        errs.append(k4_check(ctx, f"the main path's scan {i + 1} ({lanes} "
                             f"lanes)", pe, demand, valid, size0, args))
        main.setdefault(lanes, (pe, demand, valid, size0, args))
    print(f"K4 == the host scan on the main path's {len(seen)} scans "
          f"(every budget and level)", flush=True)
    for seed, B, F, nch, gr, mean_bits, resv_max, vkind in K4_CASES:
        rng = np.random.RandomState(seed)
        Rg = nch * gr
        pe = rng.uniform(0, 3000, (B, F, Rg)).astype(np.float32)
        pe[rng.rand(B, F, Rg) < 0.2] = 0.0
        demand = rng.randint(0, 4096, (B, F, Rg)).astype(np.int32)
        size0 = (rng.randint(0, max(resv_max, 8) + 1, B) // 8 * 8) \
            .astype(np.int32)
        valid = (None if vkind is None else rng.rand(F) < 0.8
                 if vkind == "holes" else rng.rand(B, F) < 0.8)
        dev = [None if x is None else torch.as_tensor(x, device="cuda")
               for x in (pe, demand, valid, size0)]
        errs.append(k4_check(
            ctx, f"random case {seed}", *dev,
            (mean_bits, resv_max, gr, nch, 28)))
    print(f"K4 == the host scan on {len(K4_CASES)} random batches (1 to 32 "
          f"clips, padded holes, resv_max 0, LSF, odd mean_bits)",
          flush=True)
    for (seed, F, nch, gr, mean_bits, resv_max, delta, s0, kinds,
         chunk) in K4_EDGES:
        rng = np.random.RandomState(seed)
        B, Rg = len(s0), nch * gr
        pe = rng.uniform(0, 3000, (B, F, Rg)).astype(np.float32)
        pe[rng.rand(B, F, Rg) < 0.2] = 0.0
        demand = rng.randint(0, 4096, (B, F, Rg)).astype(np.int32)
        C = chunk or R.chunk_frames(B, F, Rg, resv_max)
        valid = np.stack([valid_flags(k, rng, F, C) for k in kinds])
        dev = [torch.as_tensor(x, device="cuda") for x in
               (pe, demand, valid, np.array(s0, np.int32))]
        errs.append(k4_check(ctx, f"edge case {seed}", *dev,
                             (mean_bits, resv_max, gr, nch, delta), chunk))
    print(f"K4 == the host scan on {len(K4_EDGES)} edge cases (size0 off "
          f"the domain behind a leading padded run, holes across chunk "
          f"boundaries, every frame padded, resv_max 7 and 8, LSF, one "
          f"frame, chunks of 1, 2, 7, F and F + 1 frames, a negative size0 "
          f"or delta)", flush=True)
    parent = parent_library(R)
    timed = {lanes: k4_timed(ctx, f"the main path's {lanes}-lane segment",
                             *main[lanes], parent=parent)
             for lanes in sorted(main)}
    rng = np.random.RandomState(16)
    pe = torch.as_tensor(rng.uniform(0, 3000, (16, 431, 4))
                         .astype(np.float32), device="cuda")
    demand = torch.as_tensor(rng.randint(0, 4096, (16, 431, 4))
                             .astype(np.int32), device="cuda")
    size0 = torch.zeros(16, dtype=torch.int32, device="cuda")
    timed["corpus"] = k4_timed(ctx, "a corpus group of 16 (10 s clips)",
                               pe, demand, None, size0,
                               (3344, 4088, 2, 2, 28), parent=parent)
    return dict(timed[4096], max_abs_err=max(errs), by_width=timed)


def check_grid(out, kbps, rate, nsamples):
    fsize = (144000 * kbps) // rate
    nframes = -(-nsamples // 1152)
    if len(out) != nframes * fsize + 1:
        fail(f"stream length {len(out)} != {nframes} frames x {fsize} + 1")
    for f in range(nframes):
        if out[f * fsize] != 0xFF or (out[f * fsize + 1] & 0xF0) != 0xF0:
            fail(f"frame {f}: no sync word at byte {f * fsize}")
    return fsize, nframes


def phase_quality():
    """Phase 4: the quality tool on the card, every fixture."""
    from mp3tpu_torch.tools import quality
    report = quality.run([c[0] for c in quality.CASES], "cuda")
    worst = None
    for name, fx in report["fixtures"].items():
        if not fx["valid_cbr_grid"]:
            fail(f"{name}: the stream is off the CBR frame grid")
        if not fx["pass"]:
            fail(f"{name}: decoded rate or SNR below the reference bar: "
                 f"{fx['channels']}")
        for c, ch in enumerate(fx["channels"]):
            if worst is None or ch["margin_db"] < worst[0]:
                worst = (ch["margin_db"], name, c, ch["snr_db"])
    print(f"quality: {len(report['fixtures'])} fixtures on the frame grid "
          f"and at or above their ref_snr.json bars; worst margin "
          f"{worst[0]:+.2f} dB ({worst[1]} ch{worst[2]}: {worst[3]:.2f} dB)",
          flush=True)
    mpg = {n: fx["mpg123_snr_db"] for n, fx in report["fixtures"].items()}
    if all(v is None for v in mpg.values()):
        print("quality: libmpg123 is absent: no cross-decode", flush=True)
    else:
        print(f"quality: libmpg123 best-lag SNR by fixture (dB): {mpg}",
              flush=True)


def first_seconds_snr(np, out, pcm, fsize, seconds, decode_mp3, snr_db,
                      rate=44100, spf=1152):
    nf = -(-int(seconds * rate) // spf)
    dec, _ = decode_mp3(out[:nf * fsize])
    return [float(snr_db(pcm[:nf * spf, c].astype(np.float64), dec[:, c]))
            for c in range(pcm.shape[1])]


def lsf_grid(out, rate, kbps):
    """tests/test_lsf.py's check: MPEG-2 version bit, every interior frame
    on the CBR grid (an LSF stream's tail is cut mid-frame at flush)."""
    fsize = 72000 * kbps // rate
    if out[0] != 0xFF or (out[1] & 0xF0) != 0xF0:
        fail(f"LSF {rate} Hz: no sync word at byte 0")
    if (out[1] >> 3) & 1:
        fail(f"LSF {rate} Hz: version bit is not MPEG-2")
    nfull = (len(out) - 1) // fsize
    if nfull < 5:
        fail(f"LSF {rate} Hz: only {nfull} whole frames")
    for k in range(nfull - 1):
        if out[k * fsize] != 0xFF or (out[k * fsize + 1] & 0xF0) != 0xF0:
            fail(f"LSF {rate} Hz: frame {k} off the grid")
    return fsize


def reset_counts(ctx):
    ctx["S"].launches = 0
    ctx["K"].bits_at.launches = 0
    ctx["k1"].hist_c1.launches = 0
    ctx["R"].launches = 0
    ctx["R"].host_scans = 0
    ctx["A12"].launches = 0
    ctx["P12"].launches = 0
    ctx["E"].fetches = 0
    ctx["E"].retry_fetches = 0
    sharding().host_exchanges = 0
    ctx["loop"].any_on_host.syncs = 0
    ctx["loop"].reset_iterations()
    ctx["graphs"].reset_counts()
    ctx["torch"].cuda.synchronize()


def sharding():
    from mp3tpu_torch.parallel import sharding as module
    return module


def graph_count_keys(by_stage):
    """{"<stage>_captures": n, "<stage>_replays": m} of graphs.by_stage()."""
    return {f"{s}_{kind}": n for s, pair in by_stage.items()
            for kind, n in zip(("captures", "replays"), pair)}


def stage_pairs(counts):
    """{stage: (captures, replays)} of launch_counts' "<stage>_..." keys."""
    return {s: (counts[f"{s}_captures"], counts[f"{s}_replays"])
            for s in ONE_GRAPH_STAGES + SEGMENT_STAGES + L12_STAGES
            + SHARDED_ANALYSIS}


#: the host's waits on the card by kind, as launch_counts names them:
#: the rate loop's exit read on the host, the download of a host scan's
#: inputs, the download of results, a card tensor's trip through the
#: host in a gloo exchange
WAITS = {"syncs": "loop exit", "scan_copies": "scan copy",
         "fetches": "fetch", "exchanges": "gloo exchange"}


def launch_counts(ctx):
    """{kernel: launches ("resv_scan": K4, "alloc12": K5, "pack12": K6),
    "syncs": loop-exit host syncs,
    "scan_copies": host scans of the card's results, "fetches": result
    downloads ("retry_fetches": those of settle's rare retries),
    "exchanges": card tensors through the host in a gloo exchange,
    "iterations": the rate loops' live iterations (read on
    the device's sum), "captures" and "replays": CUDA graph captures and
    replays, and each stage's ("<stage>_captures", "<stage>_replays":
    graphs.STAGES)} since reset_counts."""
    torch = ctx["torch"]
    return {"search": ctx["S"].launches, "bits_at": ctx["K"].bits_at.launches,
            "hist_c1": ctx["k1"].hist_c1.launches,
            "resv_scan": ctx["R"].launches,
            "alloc12": ctx["A12"].launches,
            "pack12": ctx["P12"].launches,
            "syncs": ctx["loop"].any_on_host.syncs,
            "scan_copies": ctx["R"].host_scans,
            "fetches": ctx["E"].fetches,
            "retry_fetches": ctx["E"].retry_fetches,
            "exchanges": sharding().host_exchanges,
            "iterations": ctx["loop"].iterations(torch.device("cuda")),
            **ctx["graphs"].totals(),
            **graph_count_keys(ctx["graphs"].by_stage())}


def waits_of(counts):
    """{kind: n} of the host's waits in launch_counts' counts."""
    return {WAITS[k]: counts[k] for k in WAITS}


#: the captured stages that every path replays: the one-shot, LSF and
#: stream paths replay the whole segment program as one graph; the corpus
#: path runs it in stages (the analysis, the rate loop and the emission),
#: as do settle's retries; the sharded path runs its analysis as two
#: graphs around the automaton's exchange between ranks
#: (parallel/clip.py), then the rate loop and the emission; the Layer I/II
#: encode replays its analysis and, with psy model 2, its back half
ONE_GRAPH_STAGES = ("segment",)
SEGMENT_STAGES = ("analysis", "prologue", "iteration", "emission")
SHARDED_ANALYSIS = ("sharded_psy", "sharded_spectra")
SHARDED_STAGES = SHARDED_ANALYSIS + ("prologue", "iteration", "emission")
L12_STAGES = ("l12_analysis", "l12_back")


def read_counts(ctx, path, stages=ONE_GRAPH_STAGES, k4=True):
    """launch_counts; fails unless the path launched K3 and replayed the
    graphs of each of `stages`, and it launched bits_at and the Layer
    I/II kernels (K5, K6) no time and
    replayed no Layer I/II graph; with the one graph (the one-shot, LSF
    and stream paths), unless it captured and replayed no graph of the
    staged form (settle's retries excepted: they re-encode with the
    staged rate loop and emission); with `k4` (every path but the sharded
    one), unless it launched K4 and made no loop-exit sync and no scan
    copy; without it (the sharded path, which scans on the host as the
    JAX package does), unless it launched K4 no time and made no
    loop-exit sync."""
    counts = launch_counts(ctx)
    if counts["search"] <= 0:
        fail(f"the {path} launched K3 no time")
    for stage in stages:
        if counts[f"{stage}_replays"] <= 0:
            fail(f"the {path} replayed the {stage} graphs no time: {counts}")
    if stages == ONE_GRAPH_STAGES:
        staged = [s for s in SEGMENT_STAGES
                  if counts[f"{s}_captures"] + counts[f"{s}_replays"]]
        if staged and (not counts["retry_fetches"] or "analysis" in staged):
            fail(f"the {path} ran graphs of the staged form {staged}: "
                 f"{counts}")
    for kernel in ("bits_at", "alloc12", "pack12", "l12_analysis_replays",
                   "l12_back_replays"):
        if counts[kernel]:
            fail(f"the {path} launched {kernel} {counts[kernel]} times")
    if k4 and (counts["resv_scan"] <= 0 or counts["syncs"]
               or counts["scan_copies"]):
        fail(f"the {path}: K4 launches {counts['resv_scan']}, loop-exit "
             f"syncs {counts['syncs']}, scan copies {counts['scan_copies']}"
             f" (expected > 0, 0, 0)")
    if not k4 and (counts["resv_scan"] or counts["syncs"]):
        fail(f"the {path}: K4 launches {counts['resv_scan']}, loop-exit "
             f"syncs {counts['syncs']} (expected 0, 0)")
    return counts


def torch_waits(ctx, fn):
    """fn()'s result and the synchronizing CUDA operations torch reports
    in it (mp3tpu_torch.tools.host_waits: what torch.cuda's sync debug
    mode "warn" warns about, and the event, stream and device
    synchronizations of torch's GPU trace, which the debug mode does not
    see): {"file:line kind": n} of the Python lines that made them."""
    return host_waits(fn, ROOT)


def waits_check(ctx, path, fn, fetches, stages=ONE_GRAPH_STAGES, k4=True):
    """fn() once more, its keys captured, with the counts reset before and
    read after (read_counts' checks, `k4` as there) and under torch_waits:
    fails unless it fetched `fetches` times besides settle's retries'
    fetches, and torch counts as many synchronizing operations (event,
    stream and device synchronizations included) as the port's counters
    (loop exits, scan copies, fetches, gloo exchanges) -- no hidden wait,
    in a retry too.  Returns (out, counts, where)."""
    reset_counts(ctx)
    out, where = torch_waits(ctx, fn)
    counts = read_counts(ctx, path, stages, k4)
    waits = waits_of(counts)
    print(f"{path}, host waits of one warm run by kind {waits} "
          f"({counts['retry_fetches']} of settle's retries); torch's "
          f"synchronizing operations {sum(where.values())} by line "
          f"{where}", flush=True)
    if counts["fetches"] - counts["retry_fetches"] != fetches or \
            sum(where.values()) != sum(waits.values()):
        fail(f"{path}: {counts['fetches']} fetches (expected {fetches}), "
             f"waits {waits}, torch's count {where}")
    return out, counts, where


def phase_lsf(ctx):
    """Phase 6: MPEG-2 LSF on the card; returns the launches on the 60 s
    clip."""
    np, torch = ctx["np"], ctx["torch"]
    EncoderConfig, mpeg = ctx["EncoderConfig"], ctx["mpeg"]
    encode, decode_mp3, snr_db = (ctx["encode"], ctx["decode_mp3"],
                                  ctx["snr_db"])
    for rate, kbps in ((22050, 64), (24000, 64), (16000, 48)):
        t = np.arange(int(0.5 * rate)) / rate
        rng = np.random.RandomState(5)
        x = 0.25 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.randn(len(t))
        pcm = np.clip(x * 20000, -32768, 32767).astype(np.int16)
        cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=kbps,
                            sample_rate_hz=rate)
        out = encode(pcm, cfg, device="cuda")
        lsf_grid(out, rate, kbps)
        dec, drate = decode_mp3(out)
        snr = float(snr_db(pcm.astype(np.float64), dec[:, 0]))
        if drate != rate or not snr > 25.0:
            fail(f"LSF {rate} Hz {kbps} kbps: rate {drate}, SNR {snr:.2f} dB")
        print(f"LSF {rate} Hz {kbps} kbps mono 0.5 s: MPEG-2 grid, decoded "
              f"SNR {snr:.2f} dB (> 25)", flush=True)

    rate, kbps = 24000, 64
    pcm = ctx["make_signal"](CLIP_SECONDS, rate)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=kbps,
                        sample_rate_hz=rate)
    reset_counts(ctx)
    t0 = time.perf_counter()
    out = encode(pcm, cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = read_counts(ctx, "LSF path")
    fsize = lsf_grid(out, rate, kbps)
    with yardstick_form():
        if encode(pcm, cfg, device="cuda") != out:
            fail("LSF 60 s: the segment graphs and the yardstick form give "
                 "other bytes")
    _, seen = record_segments(ctx, lambda: encode(pcm, cfg, device="cuda"))
    segment_check(ctx, seen, "LSF 60 s")
    warm_out, launches["warm"], _ = waits_check(
        ctx, "LSF path", lambda: encode(pcm, cfg, device="cuda"), 1)
    if warm_out != out:
        fail("LSF 60 s: the warm encode gave other bytes")
    print(f"LSF 60 s stereo 24 kHz 64 kbps: {len(out)} bytes, interior "
          f"frames on the {fsize}-byte grid, {wall:.3f} s (first run): "
          f"{CLIP_SECONDS / wall:.2f}x real time; launches {launches}; the "
          f"yardstick form gives the same bytes", flush=True)
    t0 = time.perf_counter()
    encode(pcm, cfg, device="cuda")
    wall = time.perf_counter() - t0
    print(f"LSF 60 s stereo 24 kHz 64 kbps, second run: {wall:.3f} s, "
          f"{CLIP_SECONDS / wall:.2f}x real time", flush=True)
    short = pcm[:int(10.0 * rate)]
    out_cpu = encode(short, cfg, device="cpu")
    args = (np, decode_mp3, snr_db, rate, 576)
    snr_gpu = first_seconds_snr(args[0], out, pcm, fsize, 10.0, *args[1:])
    snr_cpu = first_seconds_snr(args[0], out_cpu, short, fsize, 10.0,
                                *args[1:])
    print(f"LSF first 10 s decoded SNR: cuda {snr_gpu} dB, cpu path "
          f"{snr_cpu} dB", flush=True)
    ctx["streams"]["LSF 60 s stereo 24 kHz 64 kbps"] = (
        out, pcm, rate, fsize, 576, decode_mp3)
    for g, c in zip(snr_gpu, snr_cpu):
        if not np.isfinite(g) or g < c - 1.0:
            fail(f"LSF first-10 s SNR {g:.2f} dB is more than 1 dB below "
                 f"the CPU path's {c:.2f} dB")
    return launches


def phase_stream(ctx, pcm, cfg_of):
    """Phase 7: StreamEncoder on the card against the one-shot encode;
    returns the launches on the timed stream."""
    from mp3tpu_torch.encoder import StreamEncoder
    rate = 44100
    one = ctx["encode"](pcm, cfg_of(), device="cuda", chunk=1024)

    def run(enc, lo, hi):
        out = []
        for s in range(lo, hi, rate):
            out.append(enc.feed(pcm[s:min(s + rate, hi)]))
        return b"".join(out)

    reset_counts(ctx)
    t0 = time.perf_counter()
    enc = StreamEncoder(cfg_of(), "cuda", window=1024)
    streamed = run(enc, 0, len(pcm)) + enc.finish()
    wall = time.perf_counter() - t0
    launches = read_counts(ctx, "streaming path")
    if streamed != one:
        fail(f"stream ({len(streamed)} bytes) != one-shot at chunk 1024 "
             f"({len(one)} bytes)")
    with yardstick_form():
        enc = StreamEncoder(cfg_of(), "cuda", window=1024)
        if run(enc, 0, len(pcm)) + enc.finish() != streamed:
            fail("stream: the package and the yardstick form give other "
                 "bytes")

    def whole():
        enc = StreamEncoder(cfg_of(), "cuda", window=1024)
        return run(enc, 0, len(pcm)) + enc.finish()

    _, seen = record_segments(ctx, whole)
    segment_check(ctx, seen, "stream at window 1024")
    from mp3tpu_torch.encoder import _plan_segments
    ws = 1024 * 576
    rem = len(pcm) % ws
    windows = len(pcm) // ws + (len(_plan_segments(
        2 * -(-rem // 1152), (1024,))) if rem else 0)

    def warm():
        enc = StreamEncoder(cfg_of(), "cuda", window=1024)
        return run(enc, 0, len(pcm)) + enc.finish()

    warm_out, launches["warm"], _ = waits_check(ctx, "streaming path", warm,
                                                windows)
    if warm_out != streamed:
        fail("stream: the warm run gave other bytes")
    print(f"stream: 60 s stereo 128 kbps in 1 s pieces, window 1024: "
          f"{wall:.3f} s, {CLIP_SECONDS / wall:.2f}x real time; equal to "
          f"the one-shot encode at chunk 1024 ({len(one)} bytes) and to "
          f"the yardstick form; launches {launches}; "
          f"{windows} windows", flush=True)

    cut = 30 * rate
    enc1 = StreamEncoder(cfg_of(), "cuda", window=1024)
    part1 = run(enc1, 0, cut)
    blob = pickle.dumps(enc1.checkpoint())
    del enc1
    enc2 = StreamEncoder.resume(cfg_of(), pickle.loads(blob), "cuda",
                                window=1024)
    part2 = run(enc2, cut, len(pcm)) + enc2.finish()
    if part1 + part2 != one:
        fail("checkpoint at 30 s + resume != the uninterrupted stream")
    print(f"stream: checkpoint at 30 s ({len(blob)} bytes pickled) and "
          f"resume in a fresh encoder give the same bytes", flush=True)
    return launches


L12_FIXTURES = [
    ("l2_sine_st_192", 2, "s", 192, 44100),
    ("l2_noise_j_128", 2, "j", 128, 44100),
    ("l2_sweep_mono_96", 2, "m", 96, 44100),
    ("l2_trans_st_256_48k", 2, "s", 256, 48000),
    ("l1_sine_st_384", 1, "s", 384, 44100),
    ("l1_sweep_j_256", 1, "j", 256, 44100),
]
L12_DELAY = {1: 545, 2: 481}
#: phase 8 times the card chain op by op and replayed in this many turns
#: of L12_TURN_ORDER (2 runs each)
L12_TURNS = 3
#: phase 8's timed cells on the bench signal: (label, layer, kbps); stereo
L12_CELLS = (("Layer II 192 kbps", 2, 192), ("Layer I 384 kbps", 1, 384))
#: cycles of one dependent redux.sync (__reduce_min_sync) and of one
#: vote.ballot on an SM: a shuffle's 24 and an integer operation's;
#: assumed, not measured on the card
REDUX_CYCLES, VOTE_CYCLES = 24, INT_LATENCY_CYCLES
#: K5's dependent path a greedy step (csrc/alloc12.cu walk): the lane's
#: better key (a 64-bit compare, 2 integer operations, and its select),
#: the high words' redux.sync and the move of its uniform result, the
#: compare and select of the low words, their redux.sync and move, the
#: ballot's compare, the ballot, __ffs (2), the winner's test and the
#: select that commits its new key: 12 integer operations, 2 redux.sync
#: and a ballot.  The step's price and new key, and the broadcast of the
#: bits taken, run in every lane beside the reductions
K5_PATH_CYCLES = 2 * REDUX_CYCLES + VOTE_CYCLES + 12 * INT_LATENCY_CYCLES
#: the SASS opcodes of K5's loop by the pipe that runs them on an SM:
#: 32-bit integer compare, select, logic, shift and bit counts; integer
#: multiply-add and its moves; float64; shared loads; warp reduce;
#: shuffle; anything else (branches, the warp's sync, special and uniform
#: registers) takes a dispatch slot only
SASS_PIPES = dict(
    alu=("ISETP", "SEL", "LOP3", "SHF", "PLOP3", "LEA", "VOTE", "BREV",
         "FLO", "IADD3", "IMNMX", "POPC", "PRMT"),
    fma=("IMAD", "VIADD", "FSEL", "MOV"), fp64=("DADD", "DSETP", "DMUL"),
    lds=("LDS",), redux=("REDUX",), shfl=("SHFL",))
#: results an H100 SM completes a clock, by pipe (the CUDA C++ Programming
#: Guide's throughput table for compute capability 9.0: 32-bit integer
#: compare, select, logic and shift 64; integer multiply-add 64; float64
#: add 64; shuffle 32; warp reduce 16; a shared load a warp a clock;
#: assumed, not measured on the card), and the warp instructions its 4
#: schedulers dispatch a clock
SM_RESULTS_PER_CLOCK = dict(alu=64, fma=64, fp64=64, lds=32, redux=16,
                            shfl=32)
SM_DISPATCH_PER_CLOCK = 4


def sass_loop(text, kernel):
    """[(address, instruction)] of `kernel`'s smallest loop that holds two
    REDUX.MIN (K5's walk without the copy's second key) in cuobjdump -sass
    output, without the instructions that a forward branch skips around a
    shuffle from lane 0 (Layer I's limit, recomputed only on the steps that
    move lane 0's channel-0 allocation)."""
    import re
    body = next(f for f in text.split("Function : ")[1:]
                if kernel in f.split("\n", 1)[0])
    code = [(int(a, 16), i.strip()) for a, i in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = []
    for addr, ins in code:
        m = re.search(r"BRA (?:!?U?P\d+, )?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            loop = [c for c in code if int(m.group(1), 16) <= c[0] <= addr]
            if sum("REDUX.MIN" in i for _, i in loop) == 2:
                loops.append(loop)
    loop = min(loops, key=len)
    for addr, ins in loop:
        m = re.search(r"BRA (?:!?P\d+, )?0x([0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) <= addr:
            continue
        skipped = [c for c in loop if addr < c[0] < int(m.group(1), 16)]
        if any(re.search(r"SHFL\.IDX \S+ \S+ \S+ RZ,", i)
               for _, i in skipped):
            return [c for c in loop if c not in skipped]
    return loop


def k5_step_instructions(ctx):
    """{layer: {pipe: warp instructions}} of one greedy step of K5, counted
    in the SASS of this run's build (cuobjdump -sass of
    build/liballoc12.so): the loop of sass_loop."""
    from mp3tpu_torch.ops import cuda_build
    A12 = ctx["A12"]
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", A12.LIBRARY], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out = {}
    for layer in (1, 2):
        counts = dict.fromkeys(list(SASS_PIPES) + ["other"], 0)
        for _, ins in sass_loop(text, f"alloc12_kernelILi{layer}E"):
            op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
            pipe = next((k for k, ops in SASS_PIPES.items()
                         if op.split(".")[0] in ops), "other")
            counts[pipe] += 1
        out[layer] = counts
    return out


def k5_step_sm_cycles(counts):
    """SM cycles that one warp's greedy step of K5 takes of the SM's
    throughput (`counts`: its warp instructions by pipe): the instructions
    at the schedulers' dispatch rate, or those of its busiest pipe at that
    pipe's rate, whichever is more."""
    pipes = max(counts[k] * 32 / r for k, r in SM_RESULTS_PER_CLOCK.items())
    return max(sum(counts.values()) / SM_DISPATCH_PER_CLOCK, pipes)


def l12_snr(np, orig, deco, d):
    n = min(len(orig) - d, len(deco) - d)
    o = orig[:n].astype(np.float64)
    err = o - deco[d:d + n] * 32768.0
    return 10 * np.log10((o ** 2).sum() / max((err ** 2).sum(), 1e-30))


def l12_cfg(ctx, layer, mode, kbps, rate=44100, crc=False):
    mpeg = ctx["mpeg"]
    modes = {"s": mpeg.MODE_STEREO, "j": mpeg.MODE_JOINT,
             "m": mpeg.MODE_MONO}
    return ctx["EncoderConfig"](layer=layer, mode=modes[mode],
                                bitrate_kbps=kbps, sample_rate_hz=rate,
                                error_protection=crc)


def l12_launches(ctx, path, run):
    """run() with the counts reset before and read after; fails unless it
    launched K5 and K6 once each (eagerly or in a replay of the back
    half's graph) and no Layer III kernel, and
    captured or replayed its analysis graph and its back half's graph
    once each and no Layer III graph.  Returns (run()'s result, the
    counts)."""
    reset_counts(ctx)
    out = run()
    counts = launch_counts(ctx)
    if (counts["alloc12"], counts["pack12"]) != (1, 1) or any(
            counts[k] for k in ("search", "bits_at", "hist_c1",
                                "resv_scan")) or any(
                counts[f"{s}_captures"] + counts[f"{s}_replays"] != 1
                for s in L12_STAGES) or any(
                counts[f"{s}_{kind}"] for s in ONE_GRAPH_STAGES
                + SEGMENT_STAGES + SHARDED_ANALYSIS
                for kind in ("captures", "replays")):
        fail(f"{path}: launches {counts} (expected K5 1, K6 1, no Layer "
             f"III kernel; one analysis graph and one back-half graph, no "
             f"Layer III graph)")
    return out, counts


def l12_capture(ctx, run):
    """run() in ``tools.yardstick_form()`` (the op-by-op chain: a replay
    calls no wrapper, and a capture's arguments are never computed) with
    K5's and K6's wrappers recorded at their entry (the encoder looks them
    up at each call): ([allocate args], [pack_frames args])."""
    A12, P12 = ctx["A12"], ctx["P12"]
    real_a, real_p = A12.allocate, P12.pack_frames
    seen_a, seen_p = [], []

    def rec_a(*args):
        seen_a.append(args)
        return real_a(*args)

    def rec_p(*args):
        seen_p.append(args)
        return real_p(*args)

    A12.allocate, P12.pack_frames = rec_a, rec_p
    try:
        with yardstick_form():
            run()
    finally:
        A12.allocate, P12.pack_frames = real_a, real_p
    return seen_a, seen_p


def k5_check(ctx, label, args):
    """K5 against its plain version on `args` (allocate's), torch.equal
    on every output, its greedy steps against the lockstep code's rounds
    (the longest frame's steps + 1, counted by a line tracer); returns
    (K5's max abs error, the longest frame's steps, every frame's steps
    summed)."""
    torch, A12 = ctx["torch"], ctx["A12"]
    from test_torch_layer12_card import lockstep_rounds
    got = A12.allocate(*args)
    torch.cuda.synchronize()
    want = A12.allocate_plain(*args)
    err = max(int((got[k].cpu().long() - want[k].long()).abs().max())
              if want[k].numel() else 0 for k in A12.OUTPUTS)
    bad = [k for k in A12.OUTPUTS if not torch.equal(got[k].cpu(), want[k])]
    if bad:
        fail(f"K5 != its plain version on {label} in {bad}")
    smr, scf, layer, table, nch, sblimit, adb, ep, joint, mode = args
    steps = int(got["steps"].max()) if smr.shape[0] else 0
    kw = dict(layer=layer, table=table, nch=nch, adb=adb,
              error_protection=ep)
    rounds = lockstep_rounds(
        smr.cpu().numpy(), None if scf is None else scf.cpu().numpy(), kw,
        want["jsbound"].numpy().astype("int64"))
    if steps + 1 != rounds:
        fail(f"K5 on {label}: the longest frame's steps {steps} + 1 != the "
             f"lockstep rounds {rounds}")
    return err, steps, int(got["steps"].sum())


def k5_bound(smr, scf, steps, total_steps, counts):
    """K5's least time (ms, "bytes" or "operations", {term: ms}): the
    largest of three terms.  "bytes": the SMR and scfsi read once; ba,
    adb_left, mode, mode_ext, jsbound and steps written once, at the HBM
    rate.  "path": the longest frame's greedy steps on one warp's
    dependent path, K5_PATH_CYCLES each.  "throughput": every frame's steps
    summed, k5_step_sm_cycles(counts) each (`counts`: a step's warp
    instructions by pipe), over the card's SMs.  Both at the boost
    clock."""
    F = smr.shape[0]
    moved = nbytes(smr) + (0 if scf is None else nbytes(scf)) + F * 69 * 4
    terms = dict(
        bytes=moved / HBM_BYTES_PER_S * 1e3,
        path=steps * K5_PATH_CYCLES / SM_CLOCK_HZ * 1e3,
        throughput=total_steps * k5_step_sm_cycles(counts) / H100_SMS
        / SM_CLOCK_HZ * 1e3)
    name = max(terms, key=terms.get)
    return terms[name], "bytes" if name == "bytes" else "operations", terms


def k6_check(ctx, label, args):
    """K6 against its plain version on `args` (pack_frames'), torch.equal
    on the whole buffer and status 0; returns the max abs error."""
    torch, P12 = ctx["torch"], ctx["P12"]
    got = P12.pack_frames(*args)
    torch.cuda.synchronize()
    want = P12.pack_frames_plain(*args)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        fail(f"K6 != its plain version on {label} (max abs error {err})")
    if P12.split(got)[0].tolist() != [0, 0]:
        fail(f"K6 on {label}: status {P12.split(got)[0].tolist()}")
    return err


def k6_bound(values, lengths, frame_bytes):
    """K6's bytes bound (ms): the rows read once, the frames and status
    written once, at the HBM rate."""
    F = values.shape[0]
    moved = nbytes(values, lengths) + F * frame_bytes + 8
    return moved / HBM_BYTES_PER_S * 1e3, "bytes"


def kernel_timed(ctx, fn, plain, plain_on_host):
    """(device ms, call ms, plain ms) of one kernel wrapper call: device
    time by torch.profiler (CUDA events behind a sleep where it records
    none; the call time where neither does), the plain version's device
    time, or its host wall (median of
    3, its download included) when it runs on the host."""
    torch = ctx["torch"]
    k_call = call_ms(fn, reps=20)
    k_dev = device_ms(fn) or queued_ms(fn) or k_call
    if plain_on_host:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain()
            times.append((time.perf_counter() - t0) * 1e3)
        p_ms = statistics.median(times)
    else:
        p_ms = device_ms(plain, reps=3) or queued_ms(plain, reps=3) \
            or call_ms(plain, reps=3)
    return k_dev, k_call, p_ms


def l12_yardstick(pcm, cfg, device):
    """``encode_layer12_fast`` in ``tools.yardstick_form()``: the card chain
    op by op, its analysis (``layer12.analyze_frames_eager``) and its back
    half (``encoder._layer12_eager``)."""
    from mp3tpu_torch.encoder import encode_layer12_fast
    with yardstick_form():
        return encode_layer12_fast(pcm, cfg, device)


def l12_route_fns(ctx):
    """The Layer I/II routes phase 8 compares: the card chain op by op,
    the card chain (the analysis and the back half replayed)."""
    return {"yardstick": l12_yardstick, "card": ctx["E"].encode_layer12_fast}


def l12_host_back(pcm, cfg):
    """The route the card chain replaced: the card's analysis, then the
    back half's plain versions on the CPU
    (tests/test_torch_layer12_card.py ``host_back_half``; the tests hold
    those to the JAX package's host marshalling and packing)."""
    from test_torch_layer12_card import host_back_half
    return host_back_half(pcm, cfg)


#: the order of phase 8's turns of the two routes
L12_TURN_ORDER = ("yardstick", "card", "card", "yardstick")


def l12_routes(ctx, pcm, cfg_of, label):
    """The card chain op by op (l12_yardstick) and replayed
    (encode_layer12_fast) on `pcm` in L12_TURNS turns of L12_TURN_ORDER:
    the walls (median of 6, RTF), the same bytes every run and the host
    back half's (l12_host_back).  Returns ({route: {"wall": s, "walls":
    [s]}}, the bytes)."""
    torch = ctx["torch"]
    runs = l12_route_fns(ctx)
    want = runs["card"](pcm, cfg_of(), "cuda")
    if runs["yardstick"](pcm, cfg_of(), "cuda") != want or \
            l12_host_back(pcm, cfg_of()) != want:
        fail(f"{label}: the card chain, its yardstick form and the host "
             f"back half give other bytes")
    walls = {r: [] for r in runs}
    for _ in range(L12_TURNS):
        for route in L12_TURN_ORDER:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = runs[route](pcm, cfg_of(), "cuda")
            walls[route].append(time.perf_counter() - t0)
            if out != want:
                fail(f"{label}: the {route} route changed its bytes")
    return {route: dict(wall=statistics.median(walls[route]),
                        walls=walls[route]) for route in runs}, want


#: the most host dispatches the card chain's analyze_frames span may make:
#: the copy into the graph's static input, the replay, the outputs' clones
#: and the streams' waits
L12_MAX_DISPATCHES = 20
#: the most host dispatches the card chain's _layer12_back span may make:
#: the back half's replay and the copy of K6's buffer (op by op the back
#: half makes about 280)
L12_BACK_MAX_DISPATCHES = 8
#: the kernels each route's spans must hold: span, a part of the kernel's
#: name in the trace; the op-by-op route ("yardstick") launches K5 and K6
#: under their own spans, the card chain in the back half's replay, under
#: _layer12_back
L12_SPAN_KERNELS = {
    "yardstick": (("greedy_allocation", "alloc12_kernel<"),
                  ("pack_elements", "pack12_kernel(")),
    "card": (("_layer12_back", "alloc12_kernel<"),
             ("_layer12_back", "pack12_kernel("))}
#: the most traced encodes l12_trace takes of a route to find each of its
#: L12_SPAN_KERNELS under its span
L12_TRACE_TRIES = 3


def kernels_under(path, span, word):
    """The device events in a trace() file of the kernel named by `word`
    whose launching host call lies inside a span `span` (nested spans
    included)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == span]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    return sum(1 for e in events if e.get("cat") in DEVICE_CATS
               and word in e["name"] and any(
                   s <= launch.get(e.get("args", {}).get("correlation"),
                                   -1) <= t for s, t in spans))


def kernel_whereabouts(path, span, word):
    """Where a trace() file puts the kernel named by `word` against the
    span `span`: its device events, and for the first the launching host
    call's category and its offsets from the span's start and end in us
    (None when the trace holds no such call), as one line."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == span]
    kernels = [e for e in events if e.get("cat") in DEVICE_CATS
               and word in e["name"]]
    if not kernels:
        return f"the trace holds no device event of {word}"
    corr = kernels[0].get("args", {}).get("correlation")
    calls = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")
             and e.get("args", {}).get("correlation") == corr]
    if not calls:
        return (f"{len(kernels)} device event(s) of {word}, correlation "
                f"{corr} held by no host call")
    call = calls[0]
    where = "; no such span" if not spans else (
        f", {call['ts'] - spans[0]['ts']:.3f} us after the span's start "
        f"and {spans[0]['ts'] + spans[0]['dur'] - call['ts']:.3f} us "
        f"before its end")
    return (f"{len(kernels)} device event(s) of {word}, launched by "
            f"{call['cat']} {call['name']}{where}")


def l12_trace_route(fn, pcm, cfg_of, label, route, want):
    """One traced encode of `route`: (span_breakdown by SPANS_L12, host
    wall s, {(span, kernel): its device events under the span} of the
    route's L12_SPAN_KERNELS, those with none as [(span, kernel)],
    {(span, kernel): kernel_whereabouts} of those); fails on other
    bytes."""
    from mp3tpu_torch.runtime.profiling import SPANS_L12, trace
    from mp3tpu_torch.tools.trace_stages import span_breakdown
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, "cuda"):
            t0 = time.perf_counter()
            out = fn(pcm, cfg_of(), "cuda")
            wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        bd = span_breakdown(path, SPANS_L12)
        bd["kernels"] = {sw: kernels_under(path, *sw)
                         for sw in L12_SPAN_KERNELS.get(route, ())}
        empty = [sw for sw, n in bd["kernels"].items() if n < 1]
        where = {sw: kernel_whereabouts(path, *sw) for sw in empty}
    if out != want:
        fail(f"{label}: the traced {route} route gave other bytes")
    return bd, wall, empty, where


def l12_trace(ctx, pcm, cfg_of, label, want):
    """One traced encode of each route: span_breakdown by the spans of
    runtime.profiling.SPANS_L12, and K5's and K6's kernel events: on the
    op-by-op route ("yardstick") one each, under greedy_allocation and
    pack_elements, each of those spans once; on the card chain one each
    under its one _layer12_back span (the back half's replay), which
    makes fewer than L12_BACK_MAX_DISPATCHES host dispatches, and no
    greedy_allocation, _marshal_layer12 or
    pack_elements span; fails if the card chain's analyze_frames span
    makes L12_MAX_DISPATCHES host dispatches or more.  torch.profiler
    has, on a rare run, given a trace with no device event under
    greedy_allocation (none in 220 traced encodes on an H100 80GB HBM3),
    so a route is traced again, up to L12_TRACE_TRIES encodes in all,
    while a kernel is missing from its span; each miss is printed with
    where the trace put that kernel."""
    from mp3tpu_torch.runtime.profiling import SPANS_L12
    res = {}
    for route, fn in l12_route_fns(ctx).items():
        for attempt in range(1, L12_TRACE_TRIES + 1):
            bd, wall, empty, where = l12_trace_route(fn, pcm, cfg_of, label,
                                                     route, want)
            if not empty:
                break
            print(f"{label}, {route} route traced (encode {attempt} of at "
                  f"most {L12_TRACE_TRIES}): no device event of "
                  f"{', '.join(f'{w} under {s}' for s, w in empty)}: "
                  + "; ".join(f"{s}: {w}" for (s, _), w in where.items()),
                  flush=True)
        res[route] = bd
        print(f"{label}, {route} route traced: {wall:.4f} s, "
              f"{bd['device_events']} device events "
              f"({bd['device_s'] * 1e3:.3f} ms), host dispatches "
              f"{bd['host_dispatches']}", flush=True)
        for name in SPANS_L12:
            r = bd["spans"][name]
            if r["count"]:
                print(f"  span {name}: {r['count']} x, host "
                      f"{r['host_s'] * 1e3:.3f} ms ({r['host_s'] / wall:.1%}"
                      f"), device events {r['device_events']}, device "
                      f"{r['device_s'] * 1e3:.3f} ms, host dispatches "
                      f"{r['host_dispatches']}", flush=True)
    eager = res["yardstick"]["spans"]
    for name in ("analyze_frames", "_layer12_back", "greedy_allocation",
                 "_marshal_layer12", "pack_elements", "fetch"):
        if eager[name]["count"] != 1:
            fail(f"{label}: the op-by-op chain's trace holds span {name} "
                 f"{eager[name]['count']} times")
    for route in L12_SPAN_KERNELS:
        for (name, word), n in res[route]["kernels"].items():
            if n != 1:
                fail(f"{label}: {n} device events of {word} under {name} "
                     f"in the {route} route's last of at most "
                     f"{L12_TRACE_TRIES} traces (expected 1)")
    card = res["card"]["spans"]
    for name, n in (("analyze_frames", 1), ("_layer12_back", 1),
                    ("fetch", 1), ("greedy_allocation", 0),
                    ("_marshal_layer12", 0), ("pack_elements", 0)):
        if card[name]["count"] != n:
            fail(f"{label}: the card chain's trace holds span {name} "
                 f"{card[name]['count']} times (expected {n})")
    back = card["_layer12_back"]["host_dispatches"]
    print(f"{label}, card route: _layer12_back made {back} host "
          f"dispatches and launched {card['_layer12_back']['device_events']}"
          f" device events, analyze_frames "
          f"{card['analyze_frames']['host_dispatches']} dispatches; the "
          f"op-by-op back half {eager['_layer12_back']['host_dispatches']} "
          f"dispatches", flush=True)
    if back >= L12_BACK_MAX_DISPATCHES:
        fail(f"{label}: the card chain's _layer12_back span made {back} "
             f"host dispatches (fewer than {L12_BACK_MAX_DISPATCHES} "
             f"expected)")
    if card["analyze_frames"]["host_dispatches"] >= L12_MAX_DISPATCHES or \
            card["analyze_frames"]["device_events"] < 1:
        fail(f"{label}: the card chain's analyze_frames span made "
             f"{card['analyze_frames']['host_dispatches']} host dispatches "
             f"(fewer than {L12_MAX_DISPATCHES} expected) and "
             f"{card['analyze_frames']['device_events']} device events")
    return res


def l12_waits(ctx, pcm, cfg_of, label):
    """The host's waits of a warm card-chain encode (1) and of a stream
    at 512 frames a window (one a window), by torch's count; the stream's
    launches of K5 and K6 (one a window each).  Returns {"windows",
    "alloc12", "pack12"}."""
    E = ctx["E"]
    E.encode_layer12_fast(pcm, cfg_of(), "cuda")
    out, where = torch_waits(ctx, lambda: E.encode_layer12_fast(
        pcm, cfg_of(), "cuda"))
    if sum(where.values()) != 1:
        fail(f"{label}: {sum(where.values())} host waits an encode "
             f"(expected 1): {where}")
    rate = 44100
    pieces = [pcm[s:s + rate] for s in range(0, len(pcm), rate)]
    spf = 384 if cfg_of().layer == 1 else 1152
    windows = -(-(-(-len(pcm) // spf)) // 512)

    def stream():
        return b"".join(E.encode_layer12_stream(iter(pieces), cfg_of(),
                                                "cuda"))

    stream()                    # warm: each window shape's graphs
    reset_counts(ctx)
    streamed, swhere = torch_waits(ctx, stream)
    counts = launch_counts(ctx)
    for s in L12_STAGES:
        if (counts[f"{s}_captures"], counts[f"{s}_replays"]) != (0, windows):
            fail(f"{label} stream: {s} graphs captured "
                 f"{counts[f'{s}_captures']}, replayed "
                 f"{counts[f'{s}_replays']} (expected 0 and {windows})")
    if streamed != out or sum(swhere.values()) != windows:
        fail(f"{label} stream: equal {streamed == out}, waits "
             f"{sum(swhere.values())} (expected {windows}): {swhere}")
    if (counts["alloc12"], counts["pack12"]) != (windows, windows):
        fail(f"{label} stream: K5 and K6 launches {counts['alloc12']}, "
             f"{counts['pack12']} (expected {windows} each)")
    print(f"{label}: host waits of a warm encode {where}; the stream in 1 s "
          f"pieces at 512 frames a window equals the one-shot with "
          f"{windows} waits, one a window, its analysis and back-half graphs "
          f"replayed {windows} times each; K5 launched {windows} times",
          flush=True)
    return dict(windows=windows, alloc12=counts["alloc12"],
                pack12=counts["pack12"])


def l12_analysis_check(ctx, pcm, cfg, label, seen):
    """The captured Layer I/II analysis (``layer12.analyze_frames``)
    against its op-by-op form (``analyze_frames_eager``) on an encode's
    framed and uploaded PCM, twice: torch.equal on every output.  A key's
    first call captures (its outputs are the warm-up's), the next replays
    the graph.  Adds to `seen` {"captures", "replays", "keys": [(label, F,
    dtype, capture ms)]}; fails if an output differs."""
    torch, E, np = ctx["torch"], ctx["E"], ctx["np"]
    from mp3tpu_torch.ops import layer12 as L12
    dev = torch.device("cuda")
    P, x = E._layer12_frame(pcm, cfg, dev)
    dtype = torch.int16 if x.dtype == np.int16 else torch.float32
    args = (P.layer, P.sblimit, P.nch, P.sfreq_hz)
    before = ctx["graphs"].by_stage()["l12_analysis"]
    for call in range(2):
        t = E._layer12_upload(x, dev)
        got = L12.analyze_frames(t, *args)
        want = L12.analyze_frames_eager(t, *args)
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        if bad or got.keys() != want.keys():
            fail(f"{label}: the captured analysis != analyze_frames_eager "
                 f"(call {call + 1}) on {bad or sorted(got)}")
    after = ctx["graphs"].by_stage()["l12_analysis"]
    seen["captures"] += after[0] - before[0]
    seen["replays"] += after[1] - before[1]
    if after[0] > before[0]:
        entry = L12.GRAPHS.get(L12._key(dict(pcm=t), *args))
        seen["keys"].append((label, P.F, str(dtype).split(".")[-1],
                             1e3 * entry.capture_s["l12_analysis"]))


def k5_registers(ctx):
    """Print the -Xptxas -v lines of K5 (alloc12_kernel, each layer) from
    phase 2's report, and the blocks each holds on an SM; fails unless K5
    has no stack frame and no spill."""
    A12 = ctx["A12"]
    report = A12.kernel_report(ctx["alloc12_ptxas"])
    for name, r in sorted(report.items()):
        per_sm, per_block = A12.occupancy(2 if "<2>" in name else 1)
        print(f"ptxas {name}: {r['registers']} registers, {r['stack']} "
              f"bytes stack frame, {r['spill_stores']} bytes spill stores, "
              f"{r['spill_loads']} bytes spill loads; {per_sm} blocks of "
              f"{per_block} warps an SM", flush=True)
    for name in ("alloc12_kernel<1>", "alloc12_kernel<2>"):
        r = report.get(name)
        if r is None or (r["stack"], r["spill_stores"],
                         r["spill_loads"]) != (0, 0, 0):
            fail(f"{name}: ptxas reports {r} (expected no stack frame and "
                 f"no spill)")


#: phase 8 times K5 in this many profiler windows (2 series of 20
#: launches each)
K5_WINDOWS = 3


def k5_timed(ctx, a5, layer, steps, total, counts):
    """K5 on `a5` (allocate's arguments): device time in K5_WINDOWS
    windows (the median), call time, blocks an SM and waves; the plain
    version's host time; the bound by term."""
    torch, A12 = ctx["torch"], ctx["A12"]

    def k5():
        return A12.allocate(*a5)

    turns = []
    for _ in range(K5_WINDOWS):
        got = kernel_series([k5, k5], ["alloc12_kernel"] * 2)
        if got is None:     # the profiler lost events: CUDA events instead
            got = [queued_ms(k5) for _ in range(2)]
        turns += got
    per_sm, per_block = A12.occupancy(layer)
    out = dict(ms=statistics.median(turns), turns=turns,
               call_ms=call_ms(k5, reps=20), blocks=per_sm,
               per_block=per_block, waves=A12.waves(a5[0].shape[0], layer))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A12.allocate_plain(*a5)
        times.append((time.perf_counter() - t0) * 1e3)
    b_ms, b_by, terms = k5_bound(a5[0], a5[1], steps, total, counts[layer])
    return dict(out, plain_ms=statistics.median(times), bound_ms=b_ms,
                bound_by=b_by, terms=terms,
                term=max(terms, key=terms.get))


def phase_layer12(ctx):
    """Phase 8: Layers I/II on the card; returns the measurements."""
    np, torch, E = ctx["np"], ctx["torch"], ctx["E"]
    from mp3tpu_torch.decoder import layer12 as dec12
    from mp3tpu_torch.encoder import encode_layer12_fast
    from mp3tpu_torch.ops import layer12 as L12
    golden = os.path.join(ROOT, "tests", "golden")
    worst = None
    torch.cuda.synchronize()
    L12.GRAPHS.clear()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    seen = dict(captures=0, replays=0, keys=[])

    def same_bytes(label, pcm, cfg_of, out):
        """The card chain's bytes == the yardstick form's and the host
        back half's."""
        if l12_yardstick(pcm, cfg_of(), "cuda") != out:
            fail(f"{label}: the card chain and its yardstick form give "
                 f"other bytes")
        if l12_host_back(pcm, cfg_of()) != out:
            fail(f"{label}: the card chain and the host back half give "
                 f"other bytes")
    k5_err = k6_err = 0
    k5_registers(ctx)
    step_counts = k5_step_instructions(ctx)
    for layer, counts in step_counts.items():
        print(f"K5's greedy step at Layer {'I' * layer}, warp instructions "
              f"in the SASS by pipe: {counts} ({sum(counts.values())}; "
              f"{k5_step_sm_cycles(counts):.2f} SM cycles of throughput a "
              f"warp's step); its dependent path {K5_PATH_CYCLES} cycles "
              f"(latencies assumed)", flush=True)

    def check5(label, args):
        nonlocal k5_err
        e5, steps, total = k5_check(ctx, label, args)
        k5_err = max(k5_err, e5)
        return steps, total

    for name, layer, mode, kbps, rate in L12_FIXTURES:
        pcm, _ = ctx["read_wav"](os.path.join(golden, f"{name}.wav"))
        if mode == "m":
            pcm = pcm[:, :1]
        cfg = l12_cfg(ctx, layer, mode, kbps, rate)
        l12_analysis_check(ctx, pcm, cfg, name, seen)
        out = encode_layer12_fast(pcm, cfg, "cuda")
        same_bytes(name, pcm, lambda layer=layer, mode=mode, kbps=kbps,
                   rate=rate: l12_cfg(ctx, layer, mode, kbps, rate), out)
        with open(os.path.join(golden, f"{name}.ref.mp{layer}"), "rb") as f:
            ref = f.read()
        if len(out) != len(ref) or out[:3] != ref[:3]:
            fail(f"{name}: length {len(out)} vs {len(ref)} or header "
                 f"{out[:3].hex()} vs {ref[:3].hex()}")
        dec_o, _ = dec12.decode(out)
        dec_r, _ = dec12.decode(ref)
        for c in range(pcm.shape[1]):
            s_o = l12_snr(np, pcm[:, c], dec_o[:, c], L12_DELAY[layer])
            s_r = l12_snr(np, pcm[:, c], dec_r[:, c], L12_DELAY[layer])
            if not s_o >= s_r - 0.5:
                fail(f"{name} ch{c}: SNR {s_o:.2f} dB vs reference "
                     f"{s_r:.2f} dB")
            if worst is None or s_o - s_r < worst[0]:
                worst = (s_o - s_r, name, c)
    for name, layer, kbps in (("l2_noise_st_192_crc", 2, 192),
                              ("l1_noise_st_448_48k_crc", 1, 448)):
        pcm, rate = ctx["read_wav"](os.path.join(golden, f"{name}.wav"))
        cfg_of = (lambda layer=layer, kbps=kbps, rate=rate: l12_cfg(
            ctx, layer, "s", kbps, rate, crc=True))
        l12_analysis_check(ctx, pcm, cfg_of(), name, seen)
        alloc_args, pack_args = l12_capture(
            ctx, lambda: encode_layer12_fast(pcm, cfg_of(), "cuda"))
        out = encode_layer12_fast(pcm, cfg_of(), "cuda")
        same_bytes(f"{name} (the CRC)", pcm, cfg_of, out)
        check5(name, alloc_args[0])
        k6_err = max(k6_err, k6_check(ctx, name, pack_args[0]))
        dec, _ = dec12.decode(out)
        if len(dec) < len(pcm) - 1152 or \
                not l12_snr(np, pcm[:, 0], dec[:, 0], L12_DELAY[layer]) > 0.0:
            fail(f"{name} does not decode")
    print(f"Layers I/II: 6 fixtures at the reference streams' length and "
          f"header, decoded SNR within 0.5 dB (worst {worst[0]:+.4f} dB, "
          f"{worst[1]} ch{worst[2]}); the CRC fixtures decode; the card "
          f"chain gives the yardstick form's and the host back half's bytes "
          f"on "
          f"all 8, its captured analysis analyze_frames_eager's outputs",
          flush=True)

    # K5 on the forced rows of tests/test_torch_layer12_card.py
    from test_torch_layer12_card import alloc_cases
    for label, smr, scf, kw in alloc_cases():
        args = (torch.as_tensor(smr, device="cuda"),
                None if scf is None else torch.as_tensor(scf, device="cuda"),
                kw["layer"], kw["table"], kw["nch"], kw["sblimit"],
                kw["adb"], kw["error_protection"], kw["joint"], kw["mode"])
        check5(label, args)
    print("K5 == its plain version on the forced "
          "rows of tests/test_torch_layer12_card.py (ties, +-inf, NaN, "
          "silent frames, every subband to its top, Layer I's limit) of "
          "24 configurations", flush=True)

    pcm = ctx["make_signal"](CLIP_SECONDS, 44100)
    res = dict(cells={})
    for label, layer, kbps in L12_CELLS:
        cfg_of = (lambda layer=layer, kbps=kbps: l12_cfg(ctx, layer, "s",
                                                         kbps))
        torch.cuda.synchronize()
        reserved = [torch.cuda.memory_reserved()]
        allocated = [torch.cuda.memory_allocated()]
        l12_analysis_check(ctx, pcm, cfg_of(), label, seen)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        allocated.append(torch.cuda.memory_allocated())
        out, counts = l12_launches(
            ctx, label, lambda: encode_layer12_fast(pcm, cfg_of(), "cuda"))
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        allocated.append(torch.cuda.memory_allocated())
        chain = next(reversed(L12.GRAPHS.entries.values()))
        took = [k[3] for k in seen["keys"] if k[0] == label]
        print(f"{label} {CLIP_SECONDS:g} s: the analysis graph captured "
              f"{f'in {took[0]:.1f} ms' if took else 'before'}; "
              f"torch.cuda.memory_reserved "
              f"{reserved[0] / 2**20:.1f} MiB before its capture, "
              f"{reserved[1] / 2**20:.1f} MiB after (memory_allocated "
              f"{allocated[0] / 2**20:.1f} MiB before, "
              f"{allocated[1] / 2**20:.1f} MiB after: the key's static "
              f"tensors); the encode's counts {counts}", flush=True)
        print(f"{label} {CLIP_SECONDS:g} s: the encode's key captured its "
              f"graphs in " + ", ".join(
                  f"{g} {1e3 * t:.1f} ms" for g, t in chain.capture_s.items())
              + f"; memory_reserved {reserved[2] / 2**20:.1f} MiB after "
              f"(memory_allocated {allocated[2] / 2**20:.1f} MiB)",
              flush=True)
        alloc_args, pack_args = l12_capture(
            ctx, lambda: encode_layer12_fast(pcm, cfg_of(), "cuda"))
        steps, total = check5(label, alloc_args[0])
        k6_err = max(k6_err, k6_check(ctx, label, pack_args[0]))
        P12 = ctx["P12"]
        a5, a6 = alloc_args[0], pack_args[0]
        k5 = k5_timed(ctx, a5, layer, steps, total, step_counts)
        k6_ms, k6_call, k6_plain = kernel_timed(
            ctx, lambda: P12.pack_frames(*a6),
            lambda: P12.pack_frames_plain(*a6), False)
        b6, b6_by = k6_bound(a6[0], a6[1], a6[2])
        F, Ecols = a6[0].shape
        clip = f"{label} {CLIP_SECONDS:g} s"
        F5 = a5[0].shape[0]
        print(f"{clip}: K5 == plain, {F5} frames, longest frame "
              f"{steps} greedy steps, {total} in all; {k5['blocks']} "
              f"blocks of {k5['per_block']} warps an SM, "
              f"{k5['waves']} wave(s); device {k5['ms']} ms (median of "
              f"{len(k5['turns'])}: "
              f"{', '.join(f'{t:.6f}' for t in k5['turns'])}), call "
              f"{k5['call_ms']:.4f} ms; bound {k5['bound_ms']:.6f} ms "
              f"({k5['term']}), at {k5['bound_ms'] / k5['ms']:.1%} of "
              f"it", flush=True)
        print(f"{clip}: K5's bound by term: " + ", ".join(
            f"{t} {v:.6f} ms" for t, v in k5["terms"].items())
            + f"; plain (numpy on the host with its download) "
            f"{k5['plain_ms']:.3f} ms", flush=True)
        print(f"{clip}: K6 == plain, {F} frames x {Ecols} elements of "
              f"{a6[2]} bytes; device {k6_ms} ms, call {k6_call:.4f} ms, "
              f"plain (torch ops on the card) {k6_plain} ms; bound "
              f"{b6:.6f} ms ({b6_by}), at {b6 / k6_ms:.1%} of it",
              flush=True)
        routes, want = l12_routes(ctx, pcm, cfg_of, label)
        if want != out:
            fail(f"{label}: the timed runs gave other bytes")
        for route, r in routes.items():
            print(f"{clip}, {route} route: median wall "
                  f"{r['wall']:.4f} s of {2 * L12_TURNS} in turns "
                  f"({CLIP_SECONDS / r['wall']:.2f}x real time; "
                  f"{', '.join(f'{w:.4f}' for w in r['walls'])})",
                  flush=True)
        events = {}
        for route, fn in l12_route_fns(ctx).items():
            ev, busy, wall = profile_once(lambda fn=fn: fn(pcm, cfg_of(),
                                                           "cuda"))
            events[route] = dict(events=events_by_cat(ev), busy_s=busy,
                                 wall_s=wall, idle=1 - busy / wall)
            print(f"{clip}, {route} route profiled: device events "
                  f"{events[route]['events']}, busy {busy:.4f} s of "
                  f"{wall:.4f} s (idle share {1 - busy / wall:.3f})",
                  flush=True)
        l12_trace(ctx, pcm, cfg_of, label, want)
        windows = l12_waits(ctx, pcm, cfg_of, label)
        bound5 = dict(plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"],
                      bound_by=k5["bound_by"], steps=steps)
        res["cells"][label] = dict(
            launches=counts,
            k5=dict(bound5, ms=k5["ms"], call_ms=k5["call_ms"],
                    total_steps=total, terms=k5["terms"],
                    term=k5["term"]),
            k6=dict(ms=k6_ms, call_ms=k6_call, plain_ms=k6_plain,
                    bound_ms=b6, bound_by=b6_by), routes=routes,
            events=events, windows=windows)
        if layer == 2:
            res["out"] = out

    # the bench signal at joint stereo with the CRC, both layers, and LSF
    for layer, mode, kbps, rate, crc in ((2, "j", 192, 44100, True),
                                         (1, "j", 384, 44100, True),
                                         (2, "s", 192, 44100, True),
                                         (2, "j", 96, 24000, False)):
        x = pcm if rate == 44100 else ctx["make_signal"](CLIP_SECONDS, rate)
        cfg_of = (lambda layer=layer, mode=mode, kbps=kbps, rate=rate,
                  crc=crc: l12_cfg(ctx, layer, mode, kbps, rate, crc))
        label = f"Layer {layer} {rate} Hz {kbps} kbps {mode} crc {crc}"
        l12_analysis_check(ctx, x, cfg_of(), label, seen)
        alloc_args, pack_args = l12_capture(
            ctx, lambda: encode_layer12_fast(x, cfg_of(), "cuda"))
        out = encode_layer12_fast(x, cfg_of(), "cuda")
        same_bytes(label, x, cfg_of, out)
        check5(label, alloc_args[0])
        k6_err = max(k6_err, k6_check(ctx, label, pack_args[0]))
        print(f"{label}, {CLIP_SECONDS:g} s: the card chain == the "
              f"yardstick form == the host back half ({len(out)} bytes); K5 "
              f"and "
              f"K6 == plain", flush=True)
    # psy model 1 runs on the host: two waits
    short = pcm[:int(2.0 * 44100)]

    def psy1():
        cfg = l12_cfg(ctx, 2, "s", 192)
        cfg.psy_model = 1
        return cfg

    encode_layer12_fast(short, psy1(), "cuda")
    out1, where = torch_waits(ctx, lambda: encode_layer12_fast(
        short, psy1(), "cuda"))
    if sum(where.values()) != 2 or out1 != l12_host_back(short, psy1()):
        fail(f"psy model 1: waits {where} (expected 2) or other bytes than "
             f"the host back half")
    print(f"psy model 1 (2 s): the host back half's bytes, host waits {where}",
          flush=True)

    # the Layer II stream's quality against the CPU path, as before
    cfg = l12_cfg(ctx, 2, "s", 192)
    out = res["out"]
    fsize = int(1152 / 44.1 * 192 / 8)
    nframes = -(-len(pcm) // 1152)
    if len(out) != nframes * fsize + 1:
        fail(f"Layer II stream length {len(out)} != {nframes} x {fsize} + 1")
    for f in range(nframes):
        if out[f * fsize] != 0xFF or (out[f * fsize + 1] & 0xF0) != 0xF0:
            fail(f"Layer II frame {f} off the grid")
    short = pcm[:int(10.0 * 44100)]
    out_cpu = encode_layer12_fast(short, cfg, "cpu")
    nf = -(-len(short) // 1152)
    dec_g, _ = dec12.decode(out[:nf * fsize])
    dec_c, _ = dec12.decode(out_cpu[:nf * fsize])
    snr_g = [l12_snr(np, short[:, c], dec_g[:, c], L12_DELAY[2])
             for c in range(2)]
    snr_c = [l12_snr(np, short[:, c], dec_c[:, c], L12_DELAY[2])
             for c in range(2)]
    print(f"Layer II 60 s stereo 192 kbps: frame grid ok; first 10 s SNR "
          f"cuda {snr_g} dB, cpu path {snr_c} dB", flush=True)
    for g, c in zip(snr_g, snr_c):
        if not np.isfinite(g) or g < c - 0.5:
            fail(f"Layer II first-10 s SNR {g:.2f} dB is more than 0.5 dB "
                 f"below the CPU path's {c:.2f} dB")
    ctx["streams"]["Layer II 60 s stereo 192 kbps"] = (
        out, pcm, 44100, fsize, 1152, dec12.decode)
    torch.cuda.synchronize()
    print(f"Layer I/II analysis graphs: analyze_frames == "
          f"analyze_frames_eager (torch.equal on every output) on "
          f"{len(seen['keys'])} keys captured and checked in "
          f"{seen['captures']} capture and {seen['replays']} replay calls; "
          f"capture ms by key (label, frames, dtype): "
          f"{'; '.join(f'{k[0]} {k[1]} {k[2]} {k[3]:.1f}' for k in seen['keys'])}"
          f"; {len(L12.GRAPHS)} keys held at the end; "
          f"torch.cuda.memory_reserved {reserved0 / 2**20:.1f} MiB before "
          f"phase 8's captures, {torch.cuda.memory_reserved() / 2**20:.1f} "
          f"MiB at its end", flush=True)
    if seen["captures"] < 1 or seen["replays"] < 1:
        fail(f"phase 8 checked the analysis graphs in {seen['captures']} "
             f"capture and {seen['replays']} replay calls")
    res["analysis_graphs"] = seen
    res["k5_err"], res["k6_err"] = k5_err, k6_err
    return res


def phase_cli(ctx, pcm, cfg_of):
    """Phase 9: python -m mp3tpu_torch writes the library's bytes."""
    np, EncoderConfig, mpeg = ctx["np"], ctx["EncoderConfig"], ctx["mpeg"]
    from mp3tpu_torch.encoder import encode_layer3_stream, encode_layer12_fast
    from mp3tpu_torch.runtime.wav import write_wav
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    pcm = pcm[:int(10.0 * 44100)]
    wav = os.path.join(work, "in.wav")
    write_wav(wav, pcm, 44100)
    env = dict(os.environ, PYTHONPATH=ROOT)

    def cli(args, stdin=None):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "mp3tpu_torch",
                              "--device", "cuda"] + args, input=stdin,
                             cwd=ROOT, env=env, capture_output=True,
                             timeout=300)
        if res.returncode != 0:
            fail(f"mp3tpu_torch {' '.join(args)}: rc {res.returncode}\n"
                 f"{res.stderr.decode(errors='replace')[-2000:]}")
        return time.perf_counter() - t0

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    out1 = os.path.join(work, "out.mp3")
    t1 = cli(["-b", "128", wav, out1])
    if read(out1) != ctx["encode"](pcm, cfg_of(), device="cuda"):
        fail("CLI file encode != encode_layer3_fast(..., 'cuda')")
    with yardstick_form():
        if read(out1) != ctx["encode"](pcm, cfg_of(), device="cuda"):
            fail("CLI file encode != the yardstick form's bytes")
    out2 = os.path.join(work, "out2.mp3")
    raw = pcm.astype(">i2").tobytes()
    t2 = cli(["-b", "128", "-s", "44.1", "-", out2], stdin=raw)
    lib = b"".join(encode_layer3_stream([pcm], cfg_of(), "cuda"))
    if read(out2) != lib:
        fail("CLI stdin stream != encode_layer3_stream(..., 'cuda')")
    out3 = os.path.join(work, "out3.mp2")
    t3 = cli(["-l", "2", "-b", "192", wav, out3])
    cfg = EncoderConfig(layer=2, mode=mpeg.MODE_STEREO, bitrate_kbps=192,
                        sample_rate_hz=44100)
    if read(out3) != encode_layer12_fast(pcm, cfg, "cuda"):
        fail("CLI -l 2 encode != encode_layer12_fast(..., 'cuda')")
    print(f"CLI: python -m mp3tpu_torch --device cuda equals the library "
          f"(and the yardstick form) on a 10 s WAV ({t1:.2f} s), raw stdin "
          f"stream ({t2:.2f} s) and "
          f"-l 2 ({t3:.2f} s), process start included", flush=True)


CORPUS_CLIPS = 32
CORPUS_SECONDS = 10.0
CORPUS_BATCHES = (1, 2, 4, 8, 16)


def group_split(ctx, group, kw):
    """One corpus group's wall split into the analysis
    (Layer3SegmentEncoder.analysis: one replay of the batched analysis a
    segment), the rate loops (loop.outer_loop, with the final encode's
    emission replayed after its last iteration) and the rest, each timed
    between synchronizes; and the device kernels and copies of each stage,
    counted by torch.profiler over a rerun of that stage's calls, and of
    the whole group."""
    torch, loop = ctx["torch"], ctx["loop"]
    from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder as Enc
    from mp3tpu_torch.parallel.corpus import encode_corpus_batched
    real = {"analysis": Enc.analysis, "rate loop": loop.outer_loop}
    secs = dict.fromkeys(real, 0.0)
    calls = {k: [] for k in real}

    def timed(key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[key](*args, **kwargs)
            torch.cuda.synchronize()
            secs[key] += time.perf_counter() - t0
            calls[key].append((args, kwargs))
            return out
        return run

    def encode():
        return encode_corpus_batched(group, kw, "cuda", batch=len(group))

    Enc.analysis, loop.outer_loop = timed("analysis"), timed("rate loop")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode()
        wall = time.perf_counter() - t0
    finally:
        Enc.analysis = real["analysis"]
        loop.outer_loop = real["rate loop"]
    kernels = {}
    for key, fn in real.items():
        kernels[key] = len(profile_once(
            lambda: [fn(*a, **k) for a, k in calls[key]])[0])
    kernels["whole group"] = len(profile_once(encode)[0])
    print(f"corpus group of {len(group)} clips ({2 * len(group)} lanes): "
          f"wall {wall:.4f} s with a synchronize around each stage call; "
          f"analysis {secs['analysis']:.4f} s in "
          f"{len(calls['analysis'])} calls of all lanes "
          f"({secs['analysis'] / wall:.1%}), rate loop and emission "
          f"{secs['rate loop']:.4f} s in {len(calls['rate loop'])} calls "
          f"({secs['rate loop'] / wall:.1%}), the rest "
          f"{wall - secs['analysis'] - secs['rate loop']:.4f} s; device "
          f"kernels and copies (torch.profiler): analysis "
          f"{kernels['analysis']}, rate loop and emission "
          f"{kernels['rate loop']}, whole group {kernels['whole group']}",
          flush=True)


#: phase 10 compares the corpus's group lookaheads 0 (each group collected
#: before the next is queued) and 3 (encode_corpus_batched's default, the
#: JAX package's) in this many turns of 0, 3, 3, 0
LOOKAHEADS = (0, 3)
LOOKAHEAD_TURNS = 3


def lookahead_runs(ctx, clips, batch, label, line, want):
    """encode_corpus_batched on `clips` at lane batch `batch` at each of
    LOOKAHEADS: one warm run each under waits_check (one wait a group, no
    hidden wait), its torch.cuda.max_memory_allocated, LOOKAHEAD_TURNS
    turns (median wall, aggregate real-time factor) and one profiled run
    each (device events, idle share); every run's streams must be `want`,
    clip for clip.  Returns {lookahead: record}."""
    torch = ctx["torch"]
    from mp3tpu_torch.parallel.corpus import encode_corpus_batched
    from mp3tpu_torch.tools.corpus_sweep import CORPUS_CFG
    audio = sum(max(pcm.shape) / rate for pcm, rate in clips)
    groups = -(-len(clips) // batch)

    def go(lookahead):
        outs = encode_corpus_batched(clips, CORPUS_CFG, "cuda", batch=batch,
                                     lookahead=lookahead)[0]
        if outs != want:
            bad = [i for i, (a, b) in enumerate(zip(outs, want)) if a != b]
            fail(f"{label}, lookahead {lookahead}: clips {bad} differ from "
                 f"the sweep's streams")
        return outs

    res = {}
    for la in LOOKAHEADS:
        _, counts, _ = waits_check(ctx, f"{label}, lookahead {la}",
                                   lambda: go(la), groups, SEGMENT_STAGES)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        go(la)
        torch.cuda.synchronize()
        res[la] = dict(walls=[], waits=waits_of(counts), base=base,
                       peak=torch.cuda.max_memory_allocated())
    for la in (LOOKAHEADS + LOOKAHEADS[::-1]) * LOOKAHEAD_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        go(la)
        res[la]["walls"].append(time.perf_counter() - t0)
    for la in LOOKAHEADS:
        for _ in range(3):      # the profiler now and then records none
            events, busy, pwall = profile_once(lambda: go(la))
            if events:
                break
        else:
            fail(f"{label}, lookahead {la}: torch.profiler recorded no "
                 f"device event")
        r = res[la]
        wall = statistics.median(r["walls"])
        r.update(wall=wall, rtf=audio / wall, events=len(events), busy=busy,
                 pwall=pwall, idle=1.0 - busy / pwall,
                 idle_median=1.0 - busy / wall)
        print(f"{label}, lookahead {la}: median wall {wall:.4f} s of "
              f"{len(r['walls'])} ({', '.join(f'{t:.4f}' for t in r['walls'])}"
              f" s), {audio / wall:.2f}x real time; waits of a warm run "
              f"{r['waits']} in {groups} groups; max_memory_allocated "
              f"{r['peak'] / 2**20:.1f} MiB ({r['base'] / 2**20:.1f} MiB "
              f"allocated before); one profiled run: {len(events)} device "
              f"events, by category {events_by_cat(events)}, busy "
              f"{busy:.4f} s of {pwall:.4f} s, idle share "
              f"{1.0 - busy / pwall:.3f} (against the unprofiled median "
              f"wall: {1.0 - busy / wall:.3f}); on {line}", flush=True)
    a, b = (res[la] for la in LOOKAHEADS)
    print(f"{label}: lookahead {LOOKAHEADS[1]} against {LOOKAHEADS[0]}: "
          f"wall {b['wall'] / a['wall']:.3f} of it (real-time factor "
          f"{b['rtf']:.2f}x against {a['rtf']:.2f}x), idle share "
          f"{b['idle']:.3f} against {a['idle']:.3f} of the profiled run "
          f"({b['idle_median']:.3f} against {a['idle_median']:.3f} of the "
          f"median wall), device events "
          f"{b['events']} against {a['events']}, max_memory_allocated "
          f"{b['peak'] / 2**20:.1f} against {a['peak'] / 2**20:.1f} MiB; "
          f"every clip's bytes the sweep's at both", flush=True)
    return res


def phase_corpus(ctx, line, cfg_of):
    """Phase 10: encode_corpus_batched on the card; returns the launches
    of one 32-clip encode at lane batch 16, bits_at's numbers on the
    captured 32,768-lane batch, and the streams at lane batch 2."""
    np, mpeg = ctx["np"], ctx["mpeg"]
    decode_mp3, snr_db = ctx["decode_mp3"], ctx["snr_db"]
    from mp3tpu_torch.parallel.corpus import encode_corpus_batched
    from mp3tpu_torch.tools import quality
    from mp3tpu_torch.tools.corpus_sweep import (CORPUS_CFG, RATE, corpus,
                                                 sweep)
    kw, rate = CORPUS_CFG, RATE
    clips = corpus(CORPUS_CLIPS, CORPUS_SECONDS)
    audio = CORPUS_CLIPS * CORPUS_SECONDS
    counts_of, first_of = {}, {}

    def around(batch, i, encode):
        """Run i of the sweep at `batch`: the first with the launch
        counts reset before and read after, the others equal to it."""
        if i == 0:
            reset_counts(ctx)
        outs, stats = encode()
        if i == 0:
            counts_of[batch] = read_counts(
                ctx, f"corpus at lane batch {batch}", SEGMENT_STAGES)
            first_of[batch] = outs
        elif outs != first_of[batch]:
            fail(f"corpus at lane batch {batch}: two runs differ")
        return outs, stats

    for rec in sweep(clips, CORPUS_BATCHES, "cuda", TIMED_RUNS, around):
        batch, walls, wall = rec["lane_batch"], rec["walls_s"], rec["wall_s"]
        counts = counts_of[batch]
        for out in first_of[batch]:
            check_grid(out, 128, rate, int(CORPUS_SECONDS * rate))
        groups = -(-CORPUS_CLIPS // batch)
        print(f"corpus: {CORPUS_CLIPS} stereo 44.1 kHz 128 kbps clips x "
              f"{CORPUS_SECONDS:.0f} s, lane batch {batch}: aggregate "
              f"{audio / wall:.2f}x real time, wall {wall:.4f} s median of "
              f"{TIMED_RUNS} ({', '.join(f'{w:.4f}' for w in walls)} s); "
              f"K3 launches {counts['search']} in {groups} groups "
              f"({counts['search'] / groups:.1f} a group), bits_at "
              f"{counts['bits_at']}, loop-exit syncs {counts['syncs']}, "
              f"graph captures and replays by stage {stage_pairs(counts)} "
              f"on {line}",
              flush=True)
    launches = counts_of[CORPUS_BATCHES[-1]]
    print_captures(ctx, "after the corpus sweep")

    # the group lookahead against the groups in order: bench_corpus's
    # corpus and lane batch, and the whole corpus at the widest batch
    n_clips, _, b_batch = BENCH_CORPUS
    pipelined = {
        "bench_corpus": lookahead_runs(
            ctx, clips[:n_clips], b_batch,
            f"corpus of {n_clips} at lane batch {b_batch}", line,
            first_of[b_batch][:n_clips]),
        "widest": lookahead_runs(
            ctx, clips, CORPUS_BATCHES[-1],
            f"corpus of {CORPUS_CLIPS} at lane batch {CORPUS_BATCHES[-1]}",
            line, first_of[CORPUS_BATCHES[-1]])}

    for batch in (1, CORPUS_BATCHES[-1]):
        group_split(ctx, clips[:batch], kw)
    batch = CORPUS_BATCHES[-1]
    outs, forms = form_runs(
        ctx, lambda: encode_corpus_batched(clips, kw, "cuda",
                                           batch=batch)[0],
        f"corpus at lane batch {batch}", line, audio)
    # form_runs held every clip's yardstick stream to the package's, and
    # those are the sweep's
    if outs != first_of[batch]:
        fail(f"corpus at lane batch {batch}: other bytes than the sweep's")
    warm_out, launches["warm"], _ = waits_check(
        ctx, f"corpus at lane batch {batch}",
        lambda: encode_corpus_batched(clips, kw, "cuda", batch=batch)[0],
        -(-CORPUS_CLIPS // batch), SEGMENT_STAGES)
    if warm_out != outs:
        fail(f"corpus at lane batch {batch}: the warm run gave other bytes")
    analysis_check(ctx, *corpus_analysis_args(ctx, clips[:batch], kw),
                   f"a corpus group of {batch} ({2 * batch} lanes)")

    # the eight stereo 44.1 kHz 128 kbps quality fixtures as one group
    golden = os.path.join(ROOT, "tests", "golden")
    with open(os.path.join(golden, "ref_snr.json")) as f:
        ref = json.load(f)
    names = [n for n, mode, kbps, r in quality.CASES
             if mode == mpeg.MODE_STEREO and kbps == 128 and r == rate]
    pcms = [ctx["read_wav"](os.path.join(golden, f"{n}.wav"))[0]
            for n in names]
    outs, _ = encode_corpus_batched([(p, rate) for p in pcms], kw, "cuda",
                                    batch=len(names))
    same, worst, gap = 0, None, 0.0
    for name, pcm, out in zip(names, pcms, outs):
        one = ctx["encode"](pcm, cfg_of(), device="cuda")
        check_grid(out, 128, rate, pcm.shape[0])
        if len(out) != len(one):
            fail(f"corpus {name}: {len(out)} bytes, one-shot {len(one)}")
        same += out == one
        dec, _ = decode_mp3(out)
        dec1, _ = decode_mp3(one)
        for c in range(2):
            s = float(snr_db(pcm[:, c].astype(np.float64), dec[:, c]))
            s1 = float(snr_db(pcm[:, c].astype(np.float64), dec1[:, c]))
            if not np.isfinite(s) or s < ref[name][c] or abs(s - s1) >= 0.5:
                fail(f"corpus {name} ch{c}: SNR {s:.2f} dB, bar "
                     f"{ref[name][c]} dB, one-shot {s1:.2f} dB")
            gap = max(gap, abs(s - s1))
            if worst is None or s - ref[name][c] < worst[0]:
                worst = (s - ref[name][c], name, c)
    print(f"corpus quality: the {len(names)} stereo 44.1 kHz 128 kbps "
          f"fixtures ({', '.join(str(len(p)) for p in pcms)} samples) as one "
          f"group: at or above their ref_snr.json bars (worst margin "
          f"{worst[0]:+.2f} dB, {worst[1]} ch{worst[2]}), within 0.5 dB of "
          f"their one-shot encodes (largest gap {gap:.4f} dB); {same} of "
          f"{len(names)} byte-identical to the one-shot", flush=True)

    group = clips[:CORPUS_BATCHES[-1]]
    from mp3tpu_torch.encoder import _plan_segments
    lanes = 2 * len(group) * _plan_segments(
        2 * -(-int(CORPUS_SECONDS * rate) // 1152))[0][2]
    captured, err, s_err = path_batch_check(
        ctx, lambda: encode_corpus_batched(group, kw, "cuda",
                                           batch=len(group)),
        lanes, f"corpus group of {len(group)}")
    k_dev, p_dev, _, b_ms, b_by = bits_at_timed(
        ctx, "corpus batch", first_evaluation(captured))
    k3 = search_timed(ctx, "corpus batch", "stepsize", *captured,
                      plain_too=True)
    return dict(launches=launches, max_abs_err=err, ms=k_dev,
                plain_ms=p_dev, bound_ms=b_ms, bound_by=b_by,
                search_max_abs_err=s_err, search=k3,
                batch2_outs=first_of[2], forms=forms, pipelined=pipelined)


#: phase 14: the mixed corpus of encode_corpus's worker threads,
#: (seconds, rate) of stereo 128 kbps clips: segment widths of 256,
#: 1024 and 2048 granules at two rates, 4 analysis and 8 rate-loop keys
C1_CLIPS = ((3.0, 44100), (7.0, 44100), (12.0, 44100), (4.0, 48000),
            (9.0, 48000), (15.0, 48000))


def phase_threaded_corpus(ctx, line):
    """Phase 14: encode_corpus with 3 worker threads from empty graph
    caches on C1_CLIPS, so that the threads capture several keys at once:
    every stream must equal its own encode_layer3_fast; then the wall
    with 3 workers against 1, warm, in turns 1, 3, 3, 1."""
    torch, loop, mpeg = ctx["torch"], ctx["loop"], ctx["mpeg"]
    from mp3tpu_torch.models import layer3
    from mp3tpu_torch.parallel.corpus import encode_corpus
    kw = dict(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128)
    clips = [(make_signal(sec, rate), rate) for sec, rate in C1_CLIPS]
    audio = sum(sec for sec, _ in C1_CLIPS)
    torch.cuda.synchronize()
    loop.GRAPHS.clear()
    layer3.GRAPHS.clear()
    layer3.SEGMENTS.clear()
    reset_counts(ctx)
    t0 = time.perf_counter()
    outs, _ = encode_corpus(clips, kw, "cuda", workers=3)
    cold = time.perf_counter() - t0
    counts = launch_counts(ctx)
    ones = [ctx["encode"](pcm, ctx["EncoderConfig"](sample_rate_hz=rate,
                                                    **kw), device="cuda")
            for pcm, rate in clips]
    bad = [i for i, (a, b) in enumerate(zip(outs, ones)) if a != b]
    if bad or len(outs) != len(clips):
        fail(f"encode_corpus with 3 workers: clips {bad} differ from their "
             f"own encode_layer3_fast")
    with yardstick_form():
        yard = [ctx["encode"](pcm, ctx["EncoderConfig"](
            sample_rate_hz=rate, **kw), device="cuda")
            for pcm, rate in clips]
    bad = [i for i, (a, b) in enumerate(zip(outs, yard)) if a != b]
    if bad:
        fail(f"encode_corpus with 3 workers: clips {bad} differ from their "
             f"yardstick form's bytes")
    walls = {1: [], 3: []}
    for workers in (1, 3, 3, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = encode_corpus(clips, kw, "cuda", workers=workers)
        walls[workers].append(time.perf_counter() - t0)
        if got != ones:
            fail(f"encode_corpus with {workers} workers, warm: other bytes")
    w1, w3 = statistics.mean(walls[1]), statistics.mean(walls[3])
    print(f"threaded corpus: {len(clips)} stereo 128 kbps clips "
          f"({', '.join(f'{sec:.0f} s at {rate}' for sec, rate in C1_CLIPS)}"
          f" Hz) with 3 workers from empty graph caches: {cold:.3f} s, "
          f"captures by stage {stage_pairs(counts)}; every stream equal to "
          f"its own encode_layer3_fast and to its yardstick form's; warm, "
          f"in turns: 1 worker "
          f"{', '.join(f'{w:.4f}' for w in walls[1])} s, 3 workers "
          f"{', '.join(f'{w:.4f}' for w in walls[3])} s (means "
          f"{audio / w1:.2f}x and {audio / w3:.2f}x real time, 3 workers at "
          f"{w3 / w1:.3f} of 1's wall) on {line}", flush=True)
    return dict(cold_s=cold, walls=walls, counts=counts)


def corpus_analysis_args(ctx, group, kw):
    """(encoder, (blocks_h4, fsm_init)) of the first analysis a corpus
    group makes, recorded at Layer3SegmentEncoder.analysis."""
    from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder as Enc
    from mp3tpu_torch.parallel.corpus import encode_corpus_batched
    real, seen = Enc.analysis, []

    def record(self, blocks_h4, fsm_init):
        if not seen:
            seen.append((self, (blocks_h4.clone(), fsm_init.clone())))
        return real(self, blocks_h4, fsm_init)

    Enc.analysis = record
    try:
        encode_corpus_batched(group, kw, "cuda", batch=len(group))
    finally:
        Enc.analysis = real
    return seen[0]


def print_captures(ctx, when):
    """The captured graphs held now: by stage and key, the capture ms,
    and torch.cuda.memory_reserved."""
    from mp3tpu_torch.models import layer3
    from mp3tpu_torch.ops import layer12
    torch, loop = ctx["torch"], ctx["loop"]
    rows = [f"segment {tuple(e.inputs['blocks_h4'].shape)} "
            f"{1e3 * e.capture_s['segment']:.1f}"
            for e in layer3.SEGMENTS.entries.values()]
    rows += [f"analysis {tuple(e.inputs['blocks_h4'].shape)} "
             f"{1e3 * e.capture_s['analysis']:.1f}"
             for e in layer3.GRAPHS.entries.values()]
    rows += [f"l12_analysis {tuple(e.inputs['pcm'].shape)} "
             f"{1e3 * e.capture_s['l12_analysis']:.1f}"
             for e in layer12.GRAPHS.entries.values()]
    rows += [f"{stage} {lanes} {ms}"
             for stage, lanes, ms in sharded_captures()]
    rows += [f"{name if isinstance(name, str) else name[0]} "
             f"{e.inputs['xr'].shape[0]} lanes {1e3 * t:.1f}"
             for e in loop.GRAPHS.entries.values()
             for name, t in e.capture_s.items()]
    print(f"captured graphs {when} (stage, key, capture ms): "
          f"{'; '.join(rows)}; torch.cuda.memory_reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB", flush=True)


def sharded_captures():
    """The sharded analysis graphs held now: (stage, lanes x granules,
    capture ms)."""
    from mp3tpu_torch.parallel import clip
    return [(k[0], tuple(e.inputs["ext"].shape[:2]),
             round(1e3 * e.capture_s[k[0]], 1))
            for k, e in clip.GRAPHS.entries.items()]


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_lanes(G, world):
    """The lanes of one rank's bit evaluations in encode_layer3_sharded:
    its chunks x 2 channels x the chunk size (parallel/clip.py's grid)."""
    from mp3tpu_torch.encoder import _chunk_size
    C = _chunk_size(-(-G // world))
    K = -(-(-(-G // C)) // world) * world
    return K // world * 2 * C



def sharded_rank(rank, world, url, out):
    """One rank of phase 11's gloo group, run as
    python3 chip_smoke.py --sharded-rank RANK WORLD URL OUT: the bench clip
    through encode_layer3_sharded on cuda:0 over a "cpu" mesh, once to warm
    up and once timed, then once more with this rank's bit evaluation
    captured and bits_at held against its plain chain on it; writes the
    stream to OUT and the seconds and the max abs error to OUT.json."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        fail("sharded rank: no CUDA device")
    from mp3tpu_torch.config import EncoderConfig
    from mp3tpu_torch.ops import graphs as G
    from mp3tpu_torch.ops import loop
    from mp3tpu_torch.parallel.clip import encode_layer3_sharded
    from mp3tpu_torch.parallel.corpus import init_distributed
    from mp3tpu_torch.parallel.sharding import make_mesh
    from mp3tpu_torch.tables import mpeg
    init_distributed(url, world, rank, "gloo")
    try:
        mesh = make_mesh("cpu", world)
        pcm = make_signal(CLIP_SECONDS, 44100)

        def encode():
            cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO,
                                bitrate_kbps=128, sample_rate_hz=44100)
            return encode_layer3_sharded(pcm, cfg, "cuda", mesh=mesh)

        encode()
        dist.barrier()
        G.reset_counts()
        t0 = time.perf_counter()
        data = encode()
        wall = time.perf_counter() - t0
        graphs = {**G.totals(), "by_stage": G.by_stage()}
        # the host's waits of a warm encode: torch's count against the
        # port's counters
        from mp3tpu_torch import encoder as E
        from mp3tpu_torch.ops import resv
        from mp3tpu_torch.parallel import sharding

        def counters():
            return dict(syncs=loop.any_on_host.syncs,
                        scan_copies=resv.host_scans, fetches=E.fetches,
                        exchanges=sharding.host_exchanges)

        c0 = counters()
        _, where = host_waits(encode, ROOT)
        waits = {k: v - c0[k] for k, v in counters().items()}
        with yardstick_form():
            yardstick_same = encode() == data
        _, err, s_err = path_batch_check(
            dict(torch=torch, loop=loop), encode,
            sharded_lanes(2 * -(-len(pcm) // 1152), world),
            f"sharded path (world {world}, rank {rank})")
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        f.write(data)
    with open(out + ".json", "w") as f:
        json.dump({"wall_s": wall, "max_abs_err": err,
                   "search_max_abs_err": s_err, "graphs": graphs,
                   "yardstick_same": yardstick_same, "waits": waits,
                   "torch_waits": where}, f)


def phase_sharded(ctx, cfg_of, line):
    """Phase 11: dryrun_multichip(1) on an NCCL mesh; the bench clip
    through encode_layer3_sharded at world size 1 (NCCL, this process) and
    2 (gloo, two processes, both on cuda:0), each held to the one-shot
    encode at the same chunk, and bits_at held against its plain chain on
    each run's own bit-evaluation batch.  Returns the launches of the
    world-1 encode and the largest error of those checks."""
    np, torch = ctx["np"], ctx["torch"]
    import torch.distributed as dist
    from mp3tpu_torch.decoder.layer3 import stream_block_types
    from mp3tpu_torch.encoder import _chunk_size
    from mp3tpu_torch.parallel.clip import encode_layer3_sharded
    from mp3tpu_torch.parallel.corpus import init_distributed
    from mp3tpu_torch.parallel.dryrun import dryrun_multichip
    pcm = make_signal(CLIP_SECONDS, 44100)
    G = 2 * -(-len(pcm) // 1152)
    streams = {}

    rank, world = init_distributed(f"localhost:{free_port()}", 1, 0, "nccl")
    try:
        t0 = time.perf_counter()
        dry = dryrun_multichip(1, "cuda")
        print(f"dryrun_multichip(1) on an NCCL mesh: encode_sharded and a "
              f"{len(dry)}-byte stream in {time.perf_counter() - t0:.2f} s",
              flush=True)
        encode_layer3_sharded(pcm, cfg_of(), "cuda")             # warm-up
        reset_counts(ctx)
        t0 = time.perf_counter()
        streams[1] = encode_layer3_sharded(pcm, cfg_of(), "cuda")
        walls = {1: [time.perf_counter() - t0]}
        launches = read_counts(ctx, "sharded path", SHARDED_STAGES, k4=False)
        with yardstick_form():
            if encode_layer3_sharded(pcm, cfg_of(), "cuda") != streams[1]:
                fail("sharded world 1: the graphs and the yardstick form "
                     "give other bytes")
        _, launches["warm"], _ = waits_check(
            ctx, "sharded path (world 1, NCCL)",
            lambda: encode_layer3_sharded(pcm, cfg_of(), "cuda"), 1,
            SHARDED_STAGES, k4=False)
        if launches["warm"]["scan_copies"] != 1:
            fail(f"sharded world 1: {launches['warm']['scan_copies']} scan "
                 f"downloads an encode (expected 1)")
        n_sh = len(profile_once(
            lambda: encode_layer3_sharded(pcm, cfg_of(), "cuda"))[0])
        _, err, s_err = path_batch_check(
            ctx, lambda: encode_layer3_sharded(pcm, cfg_of(), "cuda"),
            sharded_lanes(G, 1), "sharded path (world 1)")
        errs, s_errs = [err], [s_err]
    finally:
        dist.destroy_process_group()

    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    rendezvous = os.path.join(work, "rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    env = dict(os.environ, PYTHONPATH=ROOT,
               GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    outs = [os.path.join(work, f"sharded{r}.mp3") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r),
         "2", f"file://{rendezvous}", outs[r]], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            said, err = p.communicate(timeout=600)
            for text in said.decode(errors="replace").splitlines():
                print(f"rank {r} of 2: {text}", flush=True)
            if p.returncode != 0:
                fail(f"sharded rank {r} of 2: rc {p.returncode}\n"
                     f"{err.decode(errors='replace')[-3000:]}")
    finally:
        for p in procs:
            p.kill()
    ranks, replays = [], []
    walls[2] = []
    for out in outs:
        with open(out, "rb") as f:
            ranks.append(f.read())
        with open(out + ".json") as f:
            res = json.load(f)
        walls[2].append(res["wall_s"])
        by_stage = res["graphs"]["by_stage"]
        if any(by_stage[st][1] <= 0 for st in SHARDED_STAGES):
            fail(f"sharded world 2: a rank's timed encode replayed the "
                 f"{SHARDED_STAGES} graphs no time ({res['graphs']})")
        if not res["yardstick_same"]:
            fail("sharded world 2: a rank's graphs and its yardstick form "
                 "gave other bytes")
        print(f"sharded world 2, a rank's host waits of one warm encode by "
              f"kind {res['waits']}; torch's synchronizing operations "
              f"{sum(res['torch_waits'].values())} by line "
              f"{res['torch_waits']}", flush=True)
        if sum(res["waits"].values()) != sum(res["torch_waits"].values()):
            fail(f"sharded world 2: the port counts {res['waits']}, torch "
                 f"{res['torch_waits']}")
        replays.append(res["graphs"])
        errs.append(res["max_abs_err"])
        s_errs.append(res["search_max_abs_err"])
    if ranks[0] != ranks[1]:
        fail("the two gloo ranks returned different streams")
    streams[2] = ranks[0]

    one_shot = {}
    for world, data in sorted(streams.items()):
        chunk = _chunk_size(-(-G // world))
        if chunk not in one_shot:
            t0 = time.perf_counter()
            one = ctx["encode"](pcm, cfg_of(), device="cuda", chunk=chunk)
            wall1 = time.perf_counter() - t0
            fsize, _ = check_grid(one, 128, 44100, len(pcm))
            n_one = len(profile_once(lambda: ctx["encode"](
                pcm, cfg_of(), device="cuda", chunk=chunk))[0])
            one_shot[chunk] = (one, wall1, n_one, first_seconds_snr(
                np, one, pcm, fsize, 10.0, ctx["decode_mp3"], ctx["snr_db"]))
        one, wall1, n_one, snr1 = one_shot[chunk]
        if len(data) != len(one):
            fail(f"sharded world {world}: {len(data)} bytes, one-shot at "
                 f"chunk {chunk} {len(one)}")
        bt = stream_block_types(data)
        if not np.array_equal(bt, stream_block_types(one)):
            fail(f"sharded world {world}: block types differ from the "
                 f"one-shot at chunk {chunk}")
        snr = first_seconds_snr(np, data, pcm, fsize, 10.0, ctx["decode_mp3"],
                                ctx["snr_db"])
        for s, s1 in zip(snr, snr1):
            if not np.isfinite(s) or abs(s - s1) >= 0.5:
                fail(f"sharded world {world}: first-10 s SNR {s:.2f} dB, "
                     f"one-shot {s1:.2f} dB")
        how = ("NCCL, this process" if world == 1
               else "gloo, two processes on cuda:0")
        print(f"sharded {CLIP_SECONDS:.0f} s stereo 128 kbps, world size "
              f"{world} ({how}), "
              f"chunk {chunk}: {len(data)} bytes, "
              f"{'byte-identical to' if data == one else 'differs from'} the "
              f"one-shot at chunk {chunk}; block types equal "
              f"({int((bt != 0).sum())} non-long); first 10 s SNR {snr} dB "
              f"(one-shot {snr1}); timed wall "
              f"{', '.join(f'{w:.3f}' for w in walls[world])} s "
              f"({', '.join(f'{CLIP_SECONDS / w:.2f}x' for w in walls[world])}"
              f" real time; one-shot at chunk {chunk}: {wall1:.3f} s) on "
              f"{line}", flush=True)
    print(f"sharded world 1: {n_sh} device kernels and copies per encode "
          f"(torch.profiler), one-shot at chunk {_chunk_size(G)}: "
          f"{one_shot[_chunk_size(G)][2]}; graph captures and replays of "
          f"the timed encode by stage: world 1 "
          f"{stage_pairs(launches)}, "
          f"world 2 by rank {[r['by_stage'] for r in replays]}; each run's "
          f"yardstick form gives its bytes; captured graphs by stage, key "
          f"and capture ms: {sharded_captures()}", flush=True)
    return dict(launches=launches, max_abs_err=max(errs),
                search_max_abs_err=max(s_errs))


def phase_trace(ctx, pcm, cfg_of, main_out):
    """Phase 12a: runtime.profiling.trace around one bench encode; the
    trace must hold every named span (less those a replay covers,
    REPLAY_COVERS, and those of settle's re-encodes, ON_RETRY), one
    search_kernel event per K3
    launch (and as many bits_at_kernel events as bits_at launches: none)
    and one or two K4 kernel events per K4 call (the map build and the
    walk; the walk alone for one chunk); asked up to 3 times: the
    profiler now and then records no device event in a window."""
    from mp3tpu_torch.runtime.profiling import (ON_RETRY, REPLAY_COVERS,
                                                SPANS, trace)
    from mp3tpu_torch.tools.trace_stages import span_breakdown
    ctx["encode"](pcm, cfg_of(), device="cuda")     # its keys captured
    with tempfile.TemporaryDirectory() as tmp:
        for attempt in range(3):
            reset_counts(ctx)
            with trace(tmp, "cuda") as prof:
                t0 = time.perf_counter()
                out = ctx["encode"](pcm, cfg_of(), device="cuda")
                wall = time.perf_counter() - t0
            launches = read_counts(ctx, "traced main path")
            path = os.path.join(tmp, "trace.json")
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            bd = span_breakdown(path)
            parse_s = time.perf_counter() - t0
            if (bd["search_kernel_events"], bd["bits_at_kernel_events"]) \
                    == (launches["search"], launches["bits_at"]) and \
                    launches["resv_scan"] <= bd["resv_kernel_events"] \
                    <= 2 * launches["resv_scan"]:
                break
            print(f"trace attempt {attempt + 1}: "
                  f"{bd['search_kernel_events']} search_kernel and "
                  f"{bd['bits_at_kernel_events']} bits_at_kernel events "
                  f"and {bd['resv_kernel_events']} K4 kernel events "
                  f"against launches {launches}; asking again", flush=True)
        else:
            fail("the trace never held one search_kernel event per K3 "
                 "launch and one or two K4 kernel events per K4 call")
    if out != main_out:
        fail("the traced encode gave other bytes than phase 5's")
    covered = {n for names in REPLAY_COVERS.values() for n in names}
    missing = [n for n in SPANS if bd["spans"][n]["count"] == 0
               and n not in covered and n not in ON_RETRY]
    if missing:
        fail(f"the trace lacks the spans {missing}")
    print(f"trace: trace.json of {size} bytes parsed in {parse_s:.2f} s; "
          f"encode under the trace {wall:.3f} s, the same bytes as phase 5; "
          f"{bd['device_events']} device events ({bd['device_s']:.4f} s of "
          f"device time), {bd['unlinked_events']} without their launching "
          f"call in the trace; search_kernel events "
          f"{bd['search_kernel_events']} = search.launches "
          f"{launches['search']}, bits_at_kernel events "
          f"{bd['bits_at_kernel_events']}; K4's resv_map_kernel and "
          f"resv_walk_kernel events {bd['resv_kernel_events']} for "
          f"resv.launches {launches['resv_scan']}; loop-exit syncs "
          f"{launches['syncs']}",
          flush=True)
    # the trace's count and profile_once's count the same events in one
    # window (PERF.md section 6: across windows only the copies move)
    cats = events_by_cat(device_events(prof))
    if cats != bd["device_events_by_cat"]:
        fail(f"the trace window's device events by category: "
             f"span_breakdown {bd['device_events_by_cat']}, "
             f"tools.device_events {cats}")
    print(f"trace: device events by category {cats} "
          f"({sum(cats.values())}; span_breakdown and tools.device_events "
          f"agree), {bd['copy_calls_without_event']} copy and memset calls "
          f"with no device event", flush=True)
    for name in SPANS:
        r = bd["spans"][name]
        print(f"span {name}: {r['count']} x, host {r['host_s']:.4f} s "
              f"({r['host_s'] / wall:.1%} of the traced wall; self "
              f"{r['self_host_s']:.4f} s, {r['self_host_s'] / wall:.1%}); "
              f"device events {r['device_events']} (self "
              f"{r['self_device_events']}), device "
              f"{r['device_s'] * 1e3:.3f} ms (self "
              f"{r['self_device_s'] * 1e3:.3f} ms); host dispatches "
              f"{r['host_dispatches']} (self {r['self_host_dispatches']})",
              flush=True)


def phase_conformance(ctx, main_out, pcm):
    """Phase 12d: libmpg123 on the card's 60 s streams (main path, LSF,
    Layer II): the rate, the channels and the length; per channel its
    best-lag SNR over the clip and over the first 10 s, the in-repo
    decoder's over the first 10 s (it must not be more than 0.5 dB
    better) and the two decoders' agreement there (best-lag SNR of
    mpg123's output against the in-repo decoder's, at least 20 dB as in
    tests/test_conformance.py)."""
    from mp3tpu_torch.runtime import mpg123
    from mp3tpu_torch.tools.quality import best_lag_snr
    if not mpg123.available():
        print("conformance: libmpg123 is absent on this machine; the "
              "streams are not cross-decoded", flush=True)
        return
    print("conformance: libmpg123 is present", flush=True)
    streams = dict(ctx["streams"])
    streams["main path 60 s stereo 44.1 kHz 128 kbps"] = (
        main_out, pcm, 44100, 417, 1152, ctx["decode_mp3"])
    for label, (out, ref, rate, fsize, spf, decode) in streams.items():
        theirs, drate = mpg123.decode(out)
        nch = ref.shape[1]
        if drate != rate or theirs.shape[1] != nch \
                or theirs.shape[0] < len(ref) - 2 * 1152:
            fail(f"mpg123 on the {label} stream: rate {drate}, shape "
                 f"{theirs.shape} for {ref.shape} at {rate} Hz")
        nf = -(-int(10.0 * rate) // spf)
        ours = decode(out[:nf * fsize])[0] * 32768.0
        n10 = int(10.0 * rate)
        rows = []
        for c in range(nch):
            whole = best_lag_snr(ref[:, c], theirs[:, c])
            mpg10 = best_lag_snr(ref[:n10, c], theirs[:, c])
            ours10 = best_lag_snr(ref[:n10, c], ours[:, c])
            agree = best_lag_snr(ours[:n10, c], theirs[:, c])
            if not agree >= 20.0 or not mpg10 >= ours10 - 0.5:
                fail(f"mpg123 on the {label} stream ch{c}: agreement "
                     f"{agree:.2f} dB, first-10 s SNR {mpg10:.2f} dB "
                     f"against the in-repo decoder's {ours10:.2f} dB")
            rows.append(f"ch{c} {whole:.2f} dB over the clip, first 10 s "
                        f"{mpg10:.2f} dB (in-repo decoder {ours10:.2f} dB), "
                        f"agreement {agree:.2f} dB")
        print(f"conformance, {label} ({len(out)} bytes): mpg123 decodes "
              f"{theirs.shape[0]} samples x {nch} at {drate} Hz; "
              f"best-lag SNR {'; '.join(rows)}", flush=True)


def phase_tooling(ctx, pcm, cfg_of, main_out):
    """Phase 12: the trace, the trace_stages and profile_encode tools on
    the bench clip, and libmpg123 on the card's streams."""
    from mp3tpu_torch.tools import profile_encode, trace_stages
    phase_trace(ctx, pcm, cfg_of, main_out)
    t0 = time.perf_counter()
    stages = trace_stages.run(CLIP_SECONDS, "cuda")
    if stages["bytes"] != len(main_out) or \
            not all(t > 0 for t in stages["stage_isolated_s"].values()):
        fail(f"trace_stages: {stages['bytes']} bytes, stages "
             f"{stages['stage_isolated_s']}")
    print(f"trace_stages ({time.perf_counter() - t0:.2f} s): "
          f"{json.dumps(stages)}", flush=True)
    t0 = time.perf_counter()
    record = profile_encode.run(CLIP_SECONDS, "cuda")
    if record["bytes"] != len(main_out) or not record["flop_counter_flops"]:
        fail(f"profile_encode: {record['bytes']} bytes, "
             f"{record['flop_counter_flops']} FLOPs")
    print(f"profile_encode ({time.perf_counter() - t0:.2f} s): "
          f"{json.dumps(record)}", flush=True)
    phase_conformance(ctx, main_out, pcm)


#: phase 13: bench_corpus's defaults (its clips are phase 10's first 20,
#: grouped two at a time as at phase 10's lane batch 2)
BENCH_CORPUS = (20, 10.0, 2)
#: phase 13: each tool run with its defaults in this many fresh processes
FRESH_RUNS = 3
#: the keys of bench.py's and bench_corpus.py's JSON lines, and the port's
BENCH_KEYS = {"bench": ("metric", "value", "unit", "vs_baseline",
                        "spread_x", "device"),
              "bench_corpus": ("metric", "value", "unit", "vs_baseline",
                               "device")}


def bench_record(tool, record, where):
    """Fails unless `record` has exactly the tool's keys and a positive
    value."""
    if tuple(record) != BENCH_KEYS[tool] or not record["value"] > 0:
        fail(f"{tool} ({where}): {record}")
    return record


def phase_bench(main_out, corpus_outs, line):
    """Phase 13: the benchmark tools on the card.  In this process,
    bench.run's timed stream must be phase 5's and bench_corpus.run's
    streams phase 10's at lane batch 2, each on the frame grid; then each
    tool with its defaults in FRESH_RUNS fresh processes (python -m, from
    an empty temporary directory), their values printed with median,
    min and max."""
    from mp3tpu_torch.tools import bench, bench_corpus
    from mp3tpu_torch.tools.corpus_sweep import RATE
    record, out = bench.run(CLIP_SECONDS, "cuda")
    bench_record("bench", record, "in process")
    if out != main_out:
        fail(f"bench: the timed stream ({len(out)} bytes) is not phase 5's "
             f"({len(main_out)} bytes)")
    check_grid(out, 128, RATE, int(CLIP_SECONDS * RATE))
    print(f"bench in process: {json.dumps(record)}; the timed stream is "
          f"phase 5's {len(out)} bytes", flush=True)
    n_clips, seconds, batch = BENCH_CORPUS
    record, outs = bench_corpus.run(n_clips, seconds, batch, "cuda")
    bench_record("bench_corpus", record, "in process")
    if len(outs) != n_clips:
        fail(f"bench_corpus: {len(outs)} streams for {n_clips} clips")
    for i, o in enumerate(outs):
        check_grid(o, 128, RATE, int(seconds * RATE))
        if o != corpus_outs[i]:
            fail(f"bench_corpus: clip {i}'s stream is not phase 10's at "
                 f"lane batch {batch}")
    print(f"bench_corpus in process, at lookahead "
          f"{bench_corpus.LOOKAHEAD}: {json.dumps(record)}; its {n_clips} "
          f"streams are phase 10's at lane batch {batch}", flush=True)

    # with --parent-tree, the parent's tools too, in turns parent, this,
    # this, parent from the same empty directory
    trees = {"this": ROOT}
    order = ("this",) * FRESH_RUNS
    if PARENT_TREE:
        trees["parent"] = PARENT_TREE
        order = ("parent", "this", "this", "parent") * FRESH_RUNS
    with tempfile.TemporaryDirectory() as cwd:
        for tool in BENCH_KEYS:
            values = {tree: [] for tree in trees}
            for i, tree in enumerate(order):
                t0 = time.perf_counter()
                res = subprocess.run(
                    [sys.executable, "-m", f"mp3tpu_torch.tools.{tool}"],
                    cwd=cwd, env=dict(os.environ, PYTHONPATH=trees[tree]),
                    capture_output=True, text=True, timeout=600)
                wall = time.perf_counter() - t0
                if res.returncode != 0:
                    fail(f"{tool} ({tree}) in a fresh process: exit "
                         f"{res.returncode}\n{res.stderr[-3000:]}")
                record = bench_record(tool, json.loads(res.stdout),
                                      f"fresh process {i + 1}")
                values[tree].append(record["value"])
                at = (f", lookahead {bench_corpus.LOOKAHEAD}"
                      if tool == "bench_corpus" and tree == "this" else "")
                print(f"{tool}, fresh process {i + 1} ({tree} tree, "
                      f"{wall:.2f} s with its start{at}): "
                      f"{res.stdout.strip()}", flush=True)
            if os.listdir(cwd):
                fail(f"{tool} wrote {os.listdir(cwd)} into its cwd")
            for tree, v in values.items():
                print(f"{tool} with its defaults in {len(v)} fresh "
                      f"processes ({tree} tree): values {v} x_realtime, "
                      f"median {statistics.median(v)}, min {min(v)}, max "
                      f"{max(v)} on {line}", flush=True)
            if PARENT_TREE:
                this, parent = (statistics.median(values[t])
                                for t in ("this", "parent"))
                print(f"{tool}: this tree's median {this / parent:.3f} of "
                      f"the parent's, in turns", flush=True)


def phase_build(k1, K, R, A12, P12):
    """Phase 2: build the five kernel libraries, one nvcc process each,
    started together; prints the -Xptxas -v reports of bits_at.cu (its
    kernels: bits_at_kernel and K3's search_kernel), of
    resv_scan.cu (K4), alloc12.cu (K5) and pack12.cu (K6)."""
    jobs = ((k1, ()), (K, ("-Xptxas", "-v")), (R, ("-Xptxas", "-v")),
            (A12, ("-Xptxas", "-v")), (P12, ("-Xptxas", "-v")))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(mod.build, True, extra) for mod, extra in jobs]
        logs = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    for mod, extra in jobs:
        print(f"build: {os.path.relpath(mod.LIBRARY, ROOT)} from "
              f"{os.path.relpath(mod.SOURCE, ROOT)} (nvcc "
              f"{' '.join(list(mod.NVCC_FLAGS) + list(extra))})", flush=True)
    print(f"build: the {len(jobs)} libraries in {wall:.2f} s", flush=True)
    for (mod, _), log in list(zip(jobs, logs))[1:]:
        print(f"build: ptxas report for {os.path.basename(mod.SOURCE)}:\n"
              + log.strip(), flush=True)
    return {mod: log for (mod, _), log in zip(jobs, logs)}


def phase_main(ctx, pcm, cfg, line):
    """Phase 5: the bench clip five ways: the plain searches with the
    plain chain, the plain searches with the K1 chain, the plain searches
    on bits_at (the lockstep path), K3 with the rate loop op by op, each
    swapped in by this script into the segment program's staged form (a
    replayed graph calls no Python), and as the package runs it (K3, the
    segment program as one CUDA graph); the five streams must be equal,
    and the launch
    counts must show that each swap took effect.  The lockstep path and
    K3 are timed in turns and profiled once each.  Returns the package
    run's counts and measurements."""
    np, torch, loop, K = ctx["np"], ctx["torch"], ctx["loop"], ctx["K"]
    encode, decode_mp3, snr_db = (ctx["encode"], ctx["decode_mp3"],
                                  ctx["snr_db"])
    real = dict(_bits_at=loop._bits_at, search_stepsize=loop.search_stepsize,
                search_walk=loop.search_walk, outer_loop=loop.outer_loop)
    # a swapped search is Python that a replayed graph would not call: the
    # swapped ways run the rate loop op by op
    eager = dict(outer_loop=loop.outer_loop_eager)
    plain_searches = dict(eager, search_stepsize=loop.search_stepsize_plain,
                          search_walk=loop.search_walk_plain)

    def plain_chain(xr75p, qss, is_short, is_short_block, ST):
        c = K.bits_at_plain(xr75p, qss, is_short, is_short_block, ST)
        return c["bits"], c

    def k1_chain(xr75p, qss, is_short, is_short_block, ST):
        """The evaluation before bits_at: plain PyTorch around one K1
        launch."""
        ixp = loop.quantize_pow75(xr75p, qss)
        c = loop.count_all(ixp, is_short, is_short_block, ST,
                           pre_permuted=True)
        c["bits"] = torch.where(c["ix_max"] <= loop.IXMAX, c["bits"], 1e9)
        return c["bits"], c

    # the five ways: the functions swapped into loop, and the launch
    # counts that must be 0 / more than 0 after each; K3's evaluation
    # counts are read with the rate loop op by op ("k3_eager").  The
    # swapped ways run the segment program in stages (staged_form): the
    # analysis replays its graph; the emission is the rate loop's
    # continuation, op by op where the loop is.  The package's way
    # replays the one graph and no graph of the staged form.
    op_by_op = tuple(f"{s}_{kind}" for s in ("segment", "prologue",
                                              "iteration", "emission")
                     for kind in ("captures", "replays"))
    staged = tuple(f"{s}_{kind}" for s in SEGMENT_STAGES
                   for kind in ("captures", "replays"))
    ways = {"plain": (dict(plain_searches, _bits_at=plain_chain),
                      ("search", "bits_at", "hist_c1") + op_by_op, ()),
            "k1": (dict(plain_searches, _bits_at=k1_chain),
                   ("search", "bits_at") + op_by_op, ("hist_c1",)),
            "pr5": (plain_searches, ("search", "hist_c1") + op_by_op,
                    ("bits_at",)),
            "k3_eager": (eager, ("bits_at", "hist_c1") + op_by_op,
                         ("search",)),
            "k3": ({}, ("bits_at", "hist_c1") + staged,
                   ("search", "segment_replays"))}
    label = {"plain": "plain", "k1": "K1 chain", "pr5": "the lockstep path",
             "k3_eager": "K3, the rate loop op by op",
             "k3": "K3, the segment program as one CUDA graph"}

    def run(way, swaps=None):
        swaps = ways[way][0] if swaps is None else swaps
        for name, fn in swaps.items():
            setattr(loop, name, fn)
        try:
            with (contextlib.nullcontext() if way == "k3"
                  else staged_form()):
                return encode(pcm, cfg, device="cuda")
        finally:
            for name in swaps:
                setattr(loop, name, real[name])

    def counted(way, swaps=None):
        reset_counts(ctx)
        t0 = time.perf_counter()
        out = run(way, swaps)
        wall = time.perf_counter() - t0
        counts = launch_counts(ctx)
        zero, more = ways[way][1:]
        if any(counts[k] for k in zero) or not all(counts[k] for k in more):
            fail(f"main path, {label[way]}: launches {counts}: the swap did "
                 f"not take effect")
        return out, counts, wall

    outs, counts = {}, {}
    for way in ("plain", "k1", "pr5"):
        outs[way], counts[way], _ = counted(way)
    # K3's counted run also records each search's evaluation counts and
    # the evaluations K3 ran
    evals, runs = [], []

    def recording(fn):
        def record(*args, **kwargs):
            res = fn(*args, **kwargs)
            evals.append(res[2]["evals"])
            runs.append(res[2]["runs"])
            return res
        return record

    outs["k3_eager"], counts["k3_eager"], _ = counted(
        "k3_eager", dict(eager, **{k: recording(real[k])
                                   for k in ("search_stepsize",
                                             "search_walk")}))
    out, launches, first_s = counted("k3")
    for way, o in outs.items():
        if o != out:
            fail(f"main path with K3 ({len(out)} bytes) != with "
                 f"{label[way]} ({len(o)} bytes)")
    # a plain search launches bits_at as often as its slowest granule
    # evaluates in K3
    lockstep = sum(int(e.max()) for e in evals)
    per_granule = sum(int(e.sum()) for e in evals)
    ran = sum(int(r.sum()) for r in runs)
    if lockstep != counts["pr5"]["bits_at"]:
        fail(f"K3's evaluation counts give {lockstep} lockstep evaluations; "
             f"the lockstep path launched bits_at "
             f"{counts['pr5']['bits_at']} times")
    fsize, nframes = check_grid(out, 128, 44100, pcm.shape[0])
    from mp3tpu_torch.encoder import _plan_segments
    plan = _plan_segments(nframes * 2)
    print(f"main path: the plain searches with the plain chain, with the K1 "
          f"chain, on bits_at (the lockstep path), K3 with the rate loop op "
          f"by op and K3 in the segment program as one CUDA graph: the same "
          f"{len(out)} bytes", flush=True)
    for way in ("plain", "k1", "pr5", "k3_eager"):
        print(f"main path ({label[way]}): launches and waits per encode "
              f"{counts[way]}", flush=True)
    # the graph runs all 6 iterations of each of the 2 rate loops a
    # segment, launching K3 in each, and reads no exit on the host
    e, calls = counts["k3_eager"], 2 * len(plan)
    if (launches["iterations"], launches["syncs"], launches["search"]) != \
            (e["iterations"], 0, 7 * calls) or \
            e["search"] != calls + e["iterations"]:
        fail(f"main path: as CUDA graphs {launches}, op by op {e}")
    print(f"main path (K3, the segment program as one CUDA graph, first "
          f"run): "
          f"{first_s:.3f} s; launches and "
          f"waits per encode {launches}; {len(evals)} searches, "
          f"{lockstep} lockstep evaluations (= the lockstep path's bits_at "
          f"launches), "
          f"{per_granule} granule evaluations as the plain schedule counts "
          f"them, {ran} run by K3; {len(plan)} segments "
          f"{[(n_pad * 2) for _, _, n_pad in plan]} lanes; "
          f"{launches['iterations']} live iterations in {calls} rate loops "
          f"(op by op: {e['search']} K3 launches, {e['syncs']} loop-exit "
          f"syncs)", flush=True)
    # what torch's GPU trace, on for the rest of the process from the
    # first wait check, costs a warm encode: 3 runs before, 3 after
    walls = {}
    for when in ("before", "after"):
        if when == "after" and not gpu_trace_on():
            fail("torch's GPU trace was on before phase 5's wait check")
        walls[when] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run("k3")
            walls[when].append(time.perf_counter() - t0)
    print(f"main path, warm encodes before torch's GPU trace is on "
          f"{', '.join(f'{t:.4f}' for t in walls['before'])} s, with it on "
          f"{', '.join(f'{t:.4f}' for t in walls['after'])} s (medians "
          f"{statistics.median(walls['before']):.4f} / "
          f"{statistics.median(walls['after']):.4f} s); it stays on",
          flush=True)
    out_w, warm, where = waits_check(ctx, "main path", lambda: run("k3"), 1)
    if out_w != out:
        fail("main path: the warm encode gave other bytes")

    times = {"pr5": [], "k3": []}
    for way in ("pr5", "k3", "k3", "pr5") * TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_t = run(way)
        times[way].append(time.perf_counter() - t0)
        if out_t != out:
            fail(f"a timed encode ({label[way]}) gave other bytes")
    wall = statistics.median(times["k3"])
    wall_pr5 = statistics.median(times["pr5"])
    print(f"main path: 60 s stereo 128 kbps in {wall:.3f} s median of "
          f"{2 * TURNS} ({', '.join(f'{t:.3f}' for t in times['k3'])} "
          f"s): {CLIP_SECONDS / wall:.2f}x real time on {line}; in turns with "
          f"the lockstep path: {wall_pr5:.3f} s median "
          f"({', '.join(f'{t:.3f}' for t in times['pr5'])} s), "
          f"{CLIP_SECONDS / wall_pr5:.2f}x; K3's wall {wall / wall_pr5:.3f} "
          f"of the lockstep path's", flush=True)

    for way, median in (("pr5", wall_pr5), ("k3", wall)):
        for _ in range(3):      # the profiler now and then records none
            events, busy, pwall = profile_once(lambda: run(way))
            if events:
                break
        else:
            fail(f"torch.profiler recorded no device event ({label[way]})")
        print(f"torch.profiler over one encode ({label[way]}): "
              f"{len(events)} device events, by category "
              f"{events_by_cat(events)}; device busy {busy:.4f} s of a "
              f"profiled wall of {pwall:.4f} s, idle share "
              f"{1.0 - busy / pwall:.3f} (against the unprofiled median "
              f"{median:.3f} s: {1.0 - busy / median:.3f})", flush=True)

    # K3's device time summed over one encode (all 6 iterations of each
    # rate loop as graphs: 56 launches), in two windows
    k3_ms = []
    name = "search_kernel("
    for _ in range(2):
        for _ in range(3):      # until the window holds every launch
            count, ms = kernel_events(lambda: run("k3"), (name,))[name]
            if count == launches["search"]:
                break
        else:
            print(f"  (main path: the profiler recorded {count} of "
                  f"{launches['search']} {name} events)", flush=True)
            ms = None
        k3_ms.append(ms)
    print(f"main path, the searches' kernel summed over one encode "
          f"(torch.profiler, {launches['search']} launches as graphs, two "
          f"windows): K3 {' / '.join(map(str, k3_ms))} ms", flush=True)

    snr_gpu = first_seconds_snr(np, out, pcm, fsize, 10.0, decode_mp3,
                                snr_db)
    short = pcm[:int(10.0 * 44100)]
    out_cpu = encode(short, cfg, device="cpu")
    snr_cpu = first_seconds_snr(np, out_cpu, short, fsize, 10.0, decode_mp3,
                                snr_db)
    print(f"decoded SNR of the first 10 s: cuda {snr_gpu} dB, cpu path "
          f"{snr_cpu} dB", flush=True)
    for g, c in zip(snr_gpu, snr_cpu):
        if not np.isfinite(g) or g < c - 1.0:
            fail(f"first-10 s SNR {g:.2f} dB is more than 1 dB below the "
                 f"CPU path's {c:.2f} dB")
    return dict(launches=launches, by_way=counts, out=out,
                k3_encode_ms=k3_ms, warm=warm, torch_waits=where)


#: phase 5b times the rate loop op by op and as CUDA graphs in this many
#: ABBA turns (2 runs each)
GRAPH_TURNS = 3


def loop_equal(ctx, label, args, kwargs, times=1):
    """loop.outer_loop (`times` calls: a new key's first captures, the
    next replay throughout) against loop.outer_loop_eager on the same
    inputs: torch.equal on every output; fails on any difference."""
    torch, loop = ctx["torch"], ctx["loop"]
    ref = loop.outer_loop_eager(*args, **kwargs)
    for i in range(times):
        got = loop.outer_loop(*args, **kwargs)
        bad = [k for k in ref if not torch.equal(got[k], ref[k])]
        if got.keys() != ref.keys() or bad:
            fail(f"outer_loop as CUDA graphs != outer_loop_eager on {label} "
                 f"(call {i + 1}): {bad or 'keys'}")


def phase_graphs(ctx, pcm, cfg, line, main_out):
    """Phase 5b: the main path with the rate loop as CUDA graphs and op by
    op (loop.outer_loop_eager), the analysis and the emission in their
    yardstick forms in both (tools.yardstick_form): captures from
    an empty cache (capture time per key, torch.cuda.memory_reserved
    before and after), the counts of both (captures, replays, loop-exit
    syncs, K3 launches; the iterations of each outer_loop call), the same
    bytes, ABBA turns, one profiled encode each (device events, idle
    share), one traced encode each (host dispatches and device events in
    the outer_loop spans, search_kernel events = search.launches), and
    outer_loop against outer_loop_eager with torch.equal on the main
    path's own 512- and 4096-lane demand and final batches and on random
    batches at G = 4096 and 32,768, MPEG-1 and LSF."""
    torch, loop, S = ctx["torch"], ctx["loop"], ctx["S"]
    from mp3tpu_torch.runtime.profiling import trace
    from mp3tpu_torch.tools.trace_stages import span_breakdown
    from test_torch_graph_card import loop_batch
    graphed, eager = loop.outer_loop, loop.outer_loop_eager
    forms = {"graphs": graphed, "eager": eager}
    name = {"graphs": "as CUDA graphs", "eager": "op by op"}
    calls, batches = {form: [] for form in forms}, {}
    acc = loop.iterations_on(torch.device("cuda"))

    def logged(form):
        """forms[form], logging each call's lanes, kind, live iterations,
        K3 launches and loop-exit syncs (and cloning the first call of
        each lane count and kind)."""
        def call(*args, **kwargs):
            k0, s0, i0 = S.launches, loop.any_on_host.syncs, int(acc)
            out = forms[form](*args, **kwargs)
            kind = "final" if kwargs.get("qss_lo") is not None else "demand"
            G = (args[0] if args else kwargs["xr"]).shape[0]
            calls[form].append((G, kind, int(acc) - i0, S.launches - k0,
                                loop.any_on_host.syncs - s0))
            if form == "eager" and (G, kind) not in batches:
                batches[G, kind] = (
                    tuple(a.clone() if hasattr(a, "clone") else a
                          for a in args),
                    {k: v.clone() if hasattr(v, "clone") else v
                     for k, v in kwargs.items()})
            return out
        return call

    def run(form, log=False):
        # the analysis and emission in their yardstick forms, so that the
        # two forms differ in the rate loop alone
        loop.outer_loop = logged(form) if log else forms[form]
        try:
            with yardstick_form():
                return ctx["encode"](pcm, cfg, device="cuda")
        finally:
            loop.outer_loop = graphed

    # captures from an empty cache
    torch.cuda.synchronize()
    loop.GRAPHS.clear()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    counts = {}
    outs = {}
    for form in forms:
        reset_counts(ctx)
        outs[form] = run(form, log=True)
        torch.cuda.synchronize()
        counts[form] = launch_counts(ctx)
        if form == "graphs":
            reserved1 = torch.cuda.memory_reserved()
            keys = [(e.inputs["xr"].shape[0],
                     "final" if e.inputs["qss_lo"] is not None else "demand",
                     sum(e.capture_s.values()))
                    for e in loop.GRAPHS.entries.values()]
    for form, out in outs.items():
        if out != main_out:
            fail(f"main path with the rate loop {name[form]}: other bytes "
                 f"than phase 5's")
    g, e = counts["graphs"], counts["eager"]
    # both forms: the same lanes, kinds and live iterations call by call;
    # the graphs launch K3 in all 6 iterations and never sync, op by op
    # once a live iteration
    if len({tuple(c[:3] for c in calls[f]) for f in forms}) != 1 or \
            any(c[3:] != (7, 0) for c in calls["graphs"]) or \
            any(c[3] != 1 + c[2] for c in calls["eager"]):
        fail(f"the rate loop's calls: as CUDA graphs {calls['graphs']}; op "
             f"by op {calls['eager']}")
    # from an empty cache: a key's first call captures, the others replay
    replays = len(calls["graphs"]) - len(keys)
    if g["captures"] != 2 * len(keys) or \
            (g["prologue_replays"], g["iteration_replays"]) != (replays,
                                                               replays) or \
            e["captures"] or e["replays"]:
        fail(f"graph counts: as CUDA graphs {g}, op by op {e}, {len(keys)} "
             f"keys")
    print(f"rate loop as CUDA graphs: the same {len(main_out)} bytes as op "
          f"by op; counts {g} (op by op {e}); {len(keys)} keys captured: "
          f"{', '.join(f'{G} lanes {kind} {s * 1e3:.1f} ms' for G, kind, s in keys)}"
          f" (two captures each); torch.cuda.memory_reserved "
          f"{reserved0 / 2**20:.1f} MiB before the captures, "
          f"{reserved1 / 2**20:.1f} MiB after", flush=True)
    for form in forms:
        print(f"outer_loop calls of one encode {name[form]} (lanes, kind, "
              f"live iterations, K3 launches, loop-exit syncs): "
              f"{calls[form]}; live iterations "
              f"{sum(c[2] for c in calls[form])} in {len(calls[form])} "
              f"calls, iteration replays {counts[form]['iteration_replays']}",
              flush=True)

    times = {form: [] for form in forms}
    for form in ("eager", "graphs", "graphs", "eager") * GRAPH_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(form)
        times[form].append(time.perf_counter() - t0)
        if out != main_out:
            fail(f"a timed encode (rate loop {name[form]}) gave other bytes")
    res = {}
    for form in forms:
        wall = statistics.median(times[form])
        for _ in range(3):      # the profiler now and then records none
            events, busy, pwall = profile_once(lambda: run(form))
            if events:
                break
        else:
            fail(f"torch.profiler recorded no device event (rate loop "
                 f"{name[form]})")
        with tempfile.TemporaryDirectory() as tmp:
            for _ in range(3):
                reset_counts(ctx)
                with trace(tmp, "cuda"):
                    run(form)
                launches = launch_counts(ctx)
                bd = span_breakdown(os.path.join(tmp, "trace.json"))
                if bd["search_kernel_events"] == launches["search"]:
                    break
            else:
                fail(f"the trace (rate loop {name[form]}) never held one "
                     f"search_kernel event per K3 launch")
        span = bd["spans"]["outer_loop"]
        res[form] = dict(rtf=CLIP_SECONDS / wall, wall=wall,
                         dispatches=span["host_dispatches"],
                         span_events=span["device_events"],
                         events=len(events), busy=busy,
                         idle=1.0 - busy / pwall)
        print(f"main path, rate loop {name[form]}: median wall {wall:.3f} s "
              f"of {2 * GRAPH_TURNS} ({', '.join(f'{t:.3f}' for t in times[form])}"
              f" s), {CLIP_SECONDS / wall:.2f}x real time; one profiled "
              f"encode: {len(events)} device events, by category "
              f"{events_by_cat(events)}, busy {busy:.4f} s of {pwall:.4f} s, "
              f"idle share {1.0 - busy / pwall:.3f}; one traced encode: "
              f"outer_loop spans {span['count']} x {span['host_s']:.4f} s "
              f"host, {span['host_dispatches']} host dispatches (kernel and "
              f"graph launches, copies, memsets; {bd['graph_launches']} graph "
              f"launches in the trace), {span['device_events']} device "
              f"events; the whole trace {bd['host_dispatches']} dispatches, "
              f"{bd['device_events']} device events, search_kernel events "
              f"{bd['search_kernel_events']} = search.launches "
              f"{launches['search']}, {bd['unlinked_events']} unlinked; on "
              f"{line}", flush=True)
    g, e = res["graphs"], res["eager"]
    print(f"rate loop as CUDA graphs against op by op: wall "
          f"{g['wall'] / e['wall']:.3f} of it, outer_loop spans' host "
          f"dispatches {g['dispatches']} against {e['dispatches']}, their "
          f"device events {g['span_events']} against {e['span_events']}, "
          f"device busy {g['busy']:.4f} s against {e['busy']:.4f} s on "
          f"{line}", flush=True)
    if g["dispatches"] >= e["dispatches"]:
        fail(f"the rate loop as CUDA graphs made {g['dispatches']} host "
             f"dispatches, op by op {e['dispatches']}")

    for (G, kind), (args, kwargs) in sorted(batches.items()):
        loop_equal(ctx, f"the main path's first {G}-lane {kind} batch", args,
                   kwargs)
    if sorted(batches) != [(512, "demand"), (512, "final"), (4096, "demand"),
                           (4096, "final")]:
        fail(f"the main path's outer_loop batches: {sorted(batches)}")
    for G in (4096, 32768):
        for version in (ctx["mpeg"].MPEG1, ctx["mpeg"].MPEG2_LSF):
            for final in (False, True):
                args, kwargs = loop_batch("cuda", G, version, G + final,
                                          final)
                lsf = version == ctx["mpeg"].MPEG2_LSF
                loop_equal(ctx, f"a random {G}-lane "
                           f"{'LSF' if lsf else 'MPEG-1'} "
                           f"{'final' if final else 'demand'} batch", args,
                           kwargs, times=2)
    print(f"outer_loop as CUDA graphs == outer_loop_eager (torch.equal, every "
          f"output) on the main path's {len(batches)} first batches "
          f"{sorted(batches)} and on random MPEG-1 and LSF demand and final "
          f"batches at G = 4096 and 32,768 (two calls each: the capture, "
          f"then replays)", flush=True)
    return dict(counts=counts, calls=calls["graphs"], keys=keys,
                reserved=(reserved0, reserved1), **res)


#: phase 5c times the package, the staged form and the yardstick form in
#: this many turns (2 runs each), and phase 10 at lane batch 16 the
#: package and the yardstick form
SEGMENT_TURNS = 3
#: the spans whose host dispatches and device events phases 5c and 10
#: print for each form; on the card's main path (one graph a segment)
#: all but the first stay silent
FORM_SPANS = ("encode_segment_fused", "analyze_demand_fused", "outer_loop",
              "encode_final", "granule_payload", "compact_payload",
              "pack_state")
#: the most host dispatches a traced 60 s encode in the staged form may
#: make in the spans whose programs replay one graph a call:
#: analyze_demand_fused's own and granule_payload's
MAX_DISPATCHES = {"analyze_demand_fused": 100, "granule_payload": 32}
#: the most host dispatches a segment of the package (one graph) may make
#: inside its encode_segment_fused span: the inputs' copies, the replay
#: and the caller's clones
ONE_GRAPH_MAX_DISPATCHES = 30
#: the forms that form_runs can run: the package, the segment program in
#: stages (tools.staged_form) and the yardstick form
FORMS = {"graphs": contextlib.nullcontext, "staged": staged_form,
         "yardstick": yardstick_form}


def form_runs(ctx, run, label, line, audio_s, turns=SEGMENT_TURNS,
              forms=("graphs", "yardstick")):
    """run() in each of `forms` (FORMS): as the package runs it
    ("graphs": on the one-shot path the segment program as one CUDA
    graph, on the corpus path its staged graphs; one wait), the segment
    program in stages ("staged": the analysis, the rate loop and the
    emission replay CUDA graphs, the scan is K4 between them) and the
    yardstick form ("yardstick", tools.yardstick_form: the segment
    program in stages, the analysis lane by lane, the emission op by op,
    the rate loop as graphs): the counts of one run each (launches,
    waits, graph captures and replays by stage), equal outputs, `turns`
    turns in the order of `forms` reversed and then `forms` (median wall,
    real-time factor of audio_s seconds), one profiled run each (device
    events, idle share) and one traced run each (host dispatches and
    device events by span, search_kernel events = search.launches).
    Returns (the output, {form: record})."""
    torch = ctx["torch"]
    from mp3tpu_torch.runtime.profiling import trace
    from mp3tpu_torch.tools.trace_stages import span_breakdown

    def go(form):
        with FORMS[form]():
            return run()

    outs, counts = {}, {}
    for form in forms:
        reset_counts(ctx)
        outs[form] = go(form)
        torch.cuda.synchronize()
        counts[form] = launch_counts(ctx)
    for form in forms:
        if outs[form] != outs["graphs"]:
            fail(f"{label}: the package and the {form} form give other "
                 f"bytes")
    times = {form: [] for form in forms}
    for form in (tuple(reversed(forms)) + tuple(forms)) * turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = go(form)
        times[form].append(time.perf_counter() - t0)
        if out != outs["graphs"]:
            fail(f"{label}: a timed run ({form}) gave other bytes")
    res = {}
    for form in forms:
        wall = statistics.median(times[form])
        for _ in range(3):      # the profiler now and then records none
            events, busy, pwall = profile_once(lambda: go(form))
            if events:
                break
        else:
            fail(f"{label}: torch.profiler recorded no device event "
                 f"({form})")
        with tempfile.TemporaryDirectory() as tmp:
            for _ in range(3):
                reset_counts(ctx)
                with trace(tmp, "cuda"):
                    t0 = time.perf_counter()
                    go(form)
                    traced = time.perf_counter() - t0
                launches = launch_counts(ctx)
                bd = span_breakdown(os.path.join(tmp, "trace.json"))
                if bd["search_kernel_events"] == launches["search"]:
                    break
            else:
                fail(f"{label}: the trace ({form}) never held one "
                     f"search_kernel event per K3 launch")
        spans = {n: {k: bd["spans"][n][k] for k in (
            "count", "self_host_s", "host_dispatches",
            "self_host_dispatches", "device_events", "self_device_events")}
            for n in FORM_SPANS}
        res[form] = dict(wall=wall, walls=times[form], rtf=audio_s / wall,
                         events=len(events), busy=busy,
                         idle=1.0 - busy / pwall,
                         dispatches=bd["host_dispatches"],
                         device_events=bd["device_events"],
                         graph_launches=bd["graph_launches"],
                         traced_wall=traced, spans=spans,
                         counts=counts[form])
        print(f"{label}, {form}: median wall {wall:.4f} s of {2 * turns} "
              f"({', '.join(f'{t:.4f}' for t in times[form])} s), "
              f"{audio_s / wall:.2f}x real time; counts {counts[form]}; one "
              f"profiled run: {len(events)} device events, by category "
              f"{events_by_cat(events)}, busy {busy:.4f} s of {pwall:.4f} s, "
              f"idle share {1.0 - busy / pwall:.3f}; one traced run "
              f"({traced:.4f} s): {bd['host_dispatches']} host dispatches "
              f"({bd['graph_launches']} graph launches), "
              f"{bd['device_events']} device events, search_kernel events "
              f"{bd['search_kernel_events']} = search.launches "
              f"{launches['search']}; on {line}", flush=True)
        for n, r in spans.items():
            print(f"  {label}, {form}, span {n}: {r['count']} x, self host "
                  f"{r['self_host_s']:.4f} s, host dispatches "
                  f"{r['host_dispatches']} (self "
                  f"{r['self_host_dispatches']}), device events "
                  f"{r['device_events']} (self {r['self_device_events']})",
                  flush=True)
    g = res["graphs"]
    for form in forms[1:]:
        y = res[form]
        print(f"{label}: the package's wall {g['wall'] / y['wall']:.3f} of "
              f"the {form} form's (real-time factor "
              f"{g['rtf'] / y['rtf']:.3f}x), host dispatches "
              f"{g['dispatches']} against {y['dispatches']}, device events "
              f"{g['device_events']} against {y['device_events']}, device "
              f"busy {g['busy']:.4f} s against {y['busy']:.4f} s, idle "
              f"share {g['idle']:.3f} against {y['idle']:.3f}; waits "
              f"{waits_of(g['counts'])} against {waits_of(y['counts'])}",
              flush=True)
    return outs["graphs"], res


def analysis_check(ctx, enc, args, label):
    """enc.analysis (the captured batched analysis; two calls: a capture or
    a replay, then a replay) against enc.analysis_eager (lane by lane) on
    the same inputs, torch.equal on every output; then each product of
    the analysis batched alone (lanes.PER_LANE less it, the rest one a
    lane) in the batched analysis run op by op.  Fails on a difference of
    the captured analysis, or where a product outside PER_LANE changes
    the outputs when batched alone.  Returns the products whose batching
    alone changes an output."""
    torch = ctx["torch"]
    from mp3tpu_torch.ops import lanes
    ref = enc.analysis_eager(*args)
    per_lane, changed = lanes.PER_LANE, {}
    try:
        for name in lanes.PRODUCTS:
            lanes.PER_LANE = frozenset(lanes.PRODUCTS) - {name}
            got = enc._analysis(*args)
            bad = [k for k in ref if not torch.equal(got[k], ref[k])]
            if bad:
                changed[name] = bad
    finally:
        lanes.PER_LANE = per_lane
    print(f"analysis on {label} (blocks {tuple(args[0].shape)}): products "
          f"that change an output when batched alone (and the outputs): "
          f"{changed or 'none'}; one a lane in the package: "
          f"{sorted(per_lane)}", flush=True)
    for i in range(2):
        got = enc.analysis(*args)
        bad = [k for k in ref if not torch.equal(got[k], ref[k])]
        if got.keys() != ref.keys() or bad:
            fail(f"the captured analysis != analysis_eager on {label} "
                 f"(call {i + 1}): {bad or 'keys'}")
    print(f"analysis on {label}: captured == analysis_eager (torch.equal, "
          f"two calls: {', '.join(sorted(ref))})", flush=True)
    if set(changed) - per_lane:
        fail(f"batched products change the analysis on {label}: "
             f"{sorted(set(changed) - per_lane)}")
    return sorted(changed)


def record_segments(ctx, run):
    """run() with Layer3SegmentEncoder.forward wrapped, synchronizing
    around each call: each call's encoder and arguments (tensors cloned)
    and, for a call that captured its key's graph, its key (blocks_h4's
    shape), capture ms and the growth of torch.cuda.memory_allocated (the
    entry's static tensors and the call's clones) and memory_reserved
    (the graphs' pool as well) around it.  Returns (run()'s result,
    [(encoder, args, capture record or None)])."""
    torch, graphs = ctx["torch"], ctx["graphs"]
    from mp3tpu_torch.models import layer3
    Enc = layer3.Layer3SegmentEncoder
    real, seen = Enc.forward, []

    def forward(self, *args):
        kept = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
        c0 = graphs.graph_counts["segment"]["captures"]
        torch.cuda.synchronize()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        out = real(self, *args)
        torch.cuda.synchronize()
        cap = None
        if graphs.graph_counts["segment"]["captures"] > c0:
            entry = next(reversed(layer3.SEGMENTS.entries.values()))
            cap = dict(key=tuple(args[0].shape),
                       ms=1e3 * entry.capture_s["segment"],
                       allocated=torch.cuda.memory_allocated() - a0,
                       reserved=torch.cuda.memory_reserved() - r0)
        seen.append((self, kept, cap))
        return out

    Enc.forward = forward
    try:
        out = run()
    finally:
        Enc.forward = real
    return out, seen


def clone_cost(ctx, line):
    """What the caller's clones of a segment graph's static outputs cost
    (Layer3SegmentEncoder.forward's keep), for each key held in
    layer3.SEGMENTS: the outputs' count and bytes, the clones' host time
    (median of 20, no synchronize: the dispatches alone) and their device
    time (torch.profiler, the copies' events summed); beside the
    clones of what the fetch and the carry need alone (side, payload,
    n_nonfinite, scfsi, fsm_state, size)."""
    torch = ctx["torch"]
    from mp3tpu_torch.models import layer3
    need = ("side", "payload", "n_nonfinite", "scfsi", "fsm_state", "size")
    rows = []
    for entry in layer3.SEGMENTS.entries.values():
        outs = entry.outputs["segment"]
        for label, keys in (("all", tuple(outs)),
                            ("fetch and carry", tuple(k for k in need
                                                      if k in outs))):
            torch.cuda.synchronize()
            host = []
            for _ in range(20):
                t0 = time.perf_counter()
                [outs[k].clone() for k in keys]
                host.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
            events, _, _ = profile_once(lambda: [outs[k].clone()
                                                 for k in keys])
            dev_ms = sum(e - s for _, s, e in events) / 1e3
            rows.append((tuple(entry.inputs["blocks_h4"].shape), label,
                         len(keys), nbytes(*(outs[k] for k in keys)),
                         statistics.median(host) * 1e3, dev_ms))
    print("segment graph outputs' clones a call (key, which, tensors, "
          "bytes, host ms median of 20, device ms): "
          + "; ".join(f"{k} {w}: {n}, {b}, {h:.4f}, {d:.4f}"
                      for k, w, n, b, h, d in rows) + f" on {line}",
          flush=True)
    return rows


def replay_timing(ctx, line, reps=10):
    """Whether a replay's launch holds the host: for each segment graph
    held in layer3.SEGMENTS, and for the 4096-lane rate loop's iteration
    graphs in loop.GRAPHS (the staged form's largest), the host time of
    the launch alone (CUDAGraph.replay() from a synchronized card), the
    time to the card's synchronize after it, both medians of `reps`, and
    the device events and busy time of one replay (torch.profiler).  A
    launch whose host time comes near the whole is held until the card
    has taken most of the graph's work."""
    torch, loop, graphs = ctx["torch"], ctx["loop"], ctx["graphs"]
    from mp3tpu_torch.models import layer3
    dev = torch.device("cuda", torch.cuda.current_device())
    held = [(f"segment {tuple(e.inputs['blocks_h4'].shape)}",
             e.graphs["segment"]) for e in layer3.SEGMENTS.entries.values()]
    held += [(f"iteration {e.inputs['xr'].shape[0]} lanes",
              e.graphs["iteration"]) for e in loop.GRAPHS.entries.values()
             if e.inputs["xr"].shape[0] == 4096]
    rows = []
    with graphs.LOCK, torch.cuda.stream(graphs.stream(dev)):
        for name, graph in held:
            launch, whole = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                graph.replay()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                launch.append(t1 - t0)
                whole.append(time.perf_counter() - t0)
            events, busy, _ = profile_once(graph.replay)
            rows.append((name, statistics.median(launch) * 1e3,
                         statistics.median(whole) * 1e3, len(events),
                         busy * 1e3))
    print("graph replays, the launch's host time against the whole (ms, "
          "median of " + str(reps) + "), device events and busy ms of one: "
          + "; ".join(f"{n}: {a:.3f} of {w:.3f}, {k} events, {b:.3f}"
                      for n, a, w, k, b in rows) + f" on {line}",
          flush=True)
    return rows


def fingerprint_calls(run):
    """run() under cProfile: (the calls of ops/graphs.py's fingerprint,
    every function call), so that a warm encode shows that it made and
    hashed no table (layer3.rate_tables)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.runcall(run)
    stats = pstats.Stats(prof).stats
    mine = os.path.join("ops", "graphs.py")
    return (sum(nc for (path, _, name), (_, nc, *_) in stats.items()
                if name == "fingerprint" and path.endswith(mine)),
            sum(nc for _, (_, nc, *_) in stats.items()))


def segment_check(ctx, seen, label):
    """Each recorded segment call (record_segments) as one graph (the
    encoder's forward: a replay, or for a new key its capture, then a
    replay) against encode_segment_staged on the same arguments:
    torch.equal and the same dtype on every output, two calls each; fails
    on any difference."""
    torch = ctx["torch"]
    for i, (enc, args, _) in enumerate(seen):
        ref = enc.encode_segment_staged(*args)
        for call in range(2):
            got = enc(*args)
            bad = [k for k in ref if got[k].dtype != ref[k].dtype
                   or not torch.equal(got[k], ref[k])]
            if got.keys() != ref.keys() or bad:
                fail(f"{label}: segment {i} as one graph != "
                     f"encode_segment_staged (call {call + 1}): "
                     f"{bad or 'keys'}")
    print(f"{label}: each of its {len(seen)} segment calls as one graph == "
          f"encode_segment_staged (torch.equal and dtype on every output: "
          f"{', '.join(sorted(ref))}; two calls each, lanes "
          f"{[a[0].shape[0] * (a[0].shape[1] - 4) for _, a, _ in seen]}, "
          f"n_real {[a[6] for _, a, _ in seen]})", flush=True)


def phase_segment_graphs(ctx, pcm, cfg, line, main_out):
    """Phase 5c: the segment program as one CUDA graph a segment on the
    main path (the analysis, the demand rate loop, K4, the final budgets,
    the final rate loop and the emission in one replay), against its
    staged form (tools.staged_form: the analysis, rate-loop and emission
    graphs with the scan and the budgets between them) and the yardstick
    form: captures from empty caches (capture ms, memory_allocated and
    memory_reserved growth by key; the plan's 4 segments on 2 keys, n_real
    an input of the graph); each of the main path's segment calls as one
    graph against encode_segment_staged, torch.equal on every output;
    the staged form's own graphs (captured from empty caches in one
    staged encode): the captured analysis against analysis_eager on the
    main path's own 512- and 4096-lane segments with each product
    batched alone (analysis_check), and encode_final (the emission
    replayed after the rate loop) against encode_final_eager on the main
    path's own final encodes, torch.equal, two calls each; then the three
    forms in turns (form_runs): the same bytes, counts, walls, one
    profiled and one traced encode each, the package's host dispatches
    a segment held to ONE_GRAPH_MAX_DISPATCHES with no inner span
    firing, the staged form's to MAX_DISPATCHES."""
    torch, loop = ctx["torch"], ctx["loop"]
    from mp3tpu_torch.models import layer3
    Enc = layer3.Layer3SegmentEncoder

    def clear():
        torch.cuda.synchronize()
        for cache in (layer3.SEGMENTS, layer3.GRAPHS, loop.GRAPHS):
            cache.clear()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    def encode():
        return ctx["encode"](pcm, cfg, device="cuda")

    mem0 = clear()
    reset_counts(ctx)
    out, seen = record_segments(ctx, encode)
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    first = launch_counts(ctx)
    if out != main_out:
        fail("main path, capturing the segment graphs: other bytes than "
             "phase 5's")
    captured = [cap for _, _, cap in seen if cap]
    rows = "; ".join(f"{c['key']} {c['ms']:.1f} ms, "
                     f"{c['allocated'] / 2**20:.1f} MiB allocated, "
                     f"{c['reserved'] / 2**20:.1f} MiB reserved"
                     for c in captured)
    print(f"segment program as one graph, captured from empty caches in one "
          f"encode ({len(seen)} segments): counts {first}; by key (blocks, "
          f"capture ms, memory_allocated and memory_reserved growth of the "
          f"capturing call): {rows}"
          f"; torch.cuda.memory_allocated {mem0[0] / 2**20:.1f} MiB before "
          f"the captures, {mem1[0] / 2**20:.1f} MiB after, memory_reserved "
          f"{mem0[1] / 2**20:.1f} MiB before, {mem1[1] / 2**20:.1f} MiB "
          f"after; on {line}", flush=True)
    staged_counts = [f"{s}_{k}" for s in SEGMENT_STAGES
                     for k in ("captures", "replays") if first[f"{s}_{k}"]]
    if (first["segment_captures"], first["segment_replays"]) != (2, 2) or \
            len(captured) != 2 or len(layer3.SEGMENTS) != 2 or \
            staged_counts:
        fail(f"the main path's 4 segments: expected 2 keys (2 captures, 2 "
             f"replays of stage segment, none of the staged form): "
             f"{first}")
    segment_check(ctx, seen, "the main path")
    clones = clone_cost(ctx, line)

    # the staged form's own graphs, as the corpus path and settle's
    # retries replay them
    real = {"analysis": Enc.analysis, "final": Enc.encode_final}
    staged_seen = {"analysis": {}, "final": {}}

    def recorder(kind):
        def call(self, *args, **kwargs):
            key = tuple(args[0].shape)
            if key not in staged_seen[kind]:
                staged_seen[kind][key] = (self, tuple(
                    a.clone() if hasattr(a, "clone") else a for a in args),
                    {k: v.clone() if hasattr(v, "clone") else v
                     for k, v in kwargs.items()})
            return real[kind](self, *args, **kwargs)
        return call

    clear()
    reset_counts(ctx)
    Enc.analysis, Enc.encode_final = recorder("analysis"), recorder("final")
    try:
        with staged_form():
            out_s = encode()
    finally:
        Enc.analysis, Enc.encode_final = real["analysis"], real["final"]
    torch.cuda.synchronize()
    staged_first = launch_counts(ctx)
    if out_s != main_out:
        fail("main path in the staged form: other bytes than phase 5's")
    staged_captured = [("analysis", tuple(e.inputs["blocks_h4"].shape),
                        e.capture_s["analysis"])
                       for e in layer3.GRAPHS.entries.values()]
    staged_captured += [(name if isinstance(name, str) else name[0],
                         e.inputs["xr"].shape[0], t)
                        for e in loop.GRAPHS.entries.values()
                        for name, t in e.capture_s.items()]
    print(f"the staged form's graphs, captured from empty caches in one "
          f"staged encode: counts {staged_first}; capture ms by stage and "
          f"key: "
          f"{', '.join(f'{st} {k} {1e3 * t:.1f}' for st, k, t in staged_captured)}",
          flush=True)
    for stage in SEGMENT_STAGES:
        if staged_first[f"{stage}_captures"] <= 0:
            fail(f"the staged form captured no {stage} graph: "
                 f"{staged_first}")
    changed = {}
    for key, (enc, args, _) in sorted(staged_seen["analysis"].items()):
        lanes = key[0] * (key[1] - 4)
        changed[key] = analysis_check(
            ctx, enc, args, f"the main path's {lanes}-lane segment")
    if sorted(k[1] - 4 for k in staged_seen["analysis"]) != [256, 2048]:
        fail(f"the main path's analysis inputs: "
             f"{sorted(staged_seen['analysis'])}")
    for key, (enc, args, kwargs) in sorted(staged_seen["final"].items()):
        ref = enc.encode_final_eager(*args, **kwargs)
        for i in range(2):
            got = enc.encode_final(*args, **kwargs)
            if any(not torch.equal(got[k], ref[k]) for k in ("side",
                                                              "payload")):
                fail(f"encode_final (emission replayed) != "
                     f"encode_final_eager on the main path's {key[0]}-lane "
                     f"final encode (call {i + 1})")
    print(f"encode_final with the emission replayed after the rate loop == "
          f"encode_final_eager (torch.equal on side and payload, two calls "
          f"each) on the main path's final encodes "
          f"{sorted(k[0] for k in staged_seen['final'])} lanes", flush=True)

    out, res = form_runs(ctx, encode, "main path", line, CLIP_SECONDS,
                         forms=("graphs", "staged", "yardstick"))
    replays = replay_timing(ctx, line)
    hashed, calls = fingerprint_calls(encode)
    print(f"main path, a warm encode under cProfile: {hashed} calls of "
          f"graphs.fingerprint in {calls} function calls", flush=True)
    if hashed:
        fail(f"a warm encode hashed its tables: {hashed} calls of "
             f"graphs.fingerprint")
    g = res["graphs"]["spans"]
    seg = g["encode_segment_fused"]
    per_segment = seg["host_dispatches"] / max(seg["count"], 1)
    fired = [n for n in FORM_SPANS[1:] if g[n]["count"]]
    print(f"main path as one graph a segment: {seg['host_dispatches']} host "
          f"dispatches in {seg['count']} encode_segment_fused spans "
          f"({per_segment:.1f} a segment; at most "
          f"{ONE_GRAPH_MAX_DISPATCHES}), {res['graphs']['dispatches']} in "
          f"the encode (the staged form {res['staged']['dispatches']}, the "
          f"yardstick form {res['yardstick']['dispatches']}); idle share "
          f"{res['graphs']['idle']:.3f} (staged "
          f"{res['staged']['idle']:.3f}); median wall "
          f"{res['graphs']['wall']:.4f} s against the staged form's "
          f"{res['staged']['wall']:.4f} s; inner spans that fired: "
          f"{fired or 'none'}; on {line}", flush=True)
    if per_segment > ONE_GRAPH_MAX_DISPATCHES or fired:
        fail(f"main path as one graph: {per_segment:.1f} host dispatches a "
             f"segment (at most {ONE_GRAPH_MAX_DISPATCHES}), inner spans "
             f"{fired}")
    spans = res["staged"]["spans"]
    for name, most in MAX_DISPATCHES.items():
        key = ("self_host_dispatches" if name == "analyze_demand_fused"
               else "host_dispatches")
        if spans[name][key] > most:
            fail(f"main path in the staged form: span {name} made "
                 f"{spans[name][key]} host dispatches (at most {most})")
    return dict(first=first, captured=captured, staged_captured=
                staged_captured, memory=(mem0, mem1), changed=changed,
                clones=clones, replays=replays, **res)


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA GPU")
    line = card_line()
    print(line, flush=True)
    print(f"card: {line} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))",
          flush=True)

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np

    import mp3tpu_torch  # noqa: F401  (TF32 off)
    from mp3tpu_torch.config import EncoderConfig
    from mp3tpu_torch.decoder import decode_mp3
    from mp3tpu_torch.decoder.layer3 import snr_db
    from mp3tpu_torch import encoder as E
    from mp3tpu_torch.encoder import encode_layer3_fast
    from mp3tpu_torch.ops import bits_at as K
    from mp3tpu_torch.ops import graphs
    from mp3tpu_torch.ops import hist_c1 as k1
    from mp3tpu_torch.ops import loop
    from mp3tpu_torch.ops import alloc12 as A12
    from mp3tpu_torch.ops import pack12 as P12
    from mp3tpu_torch.ops import resv as R
    from mp3tpu_torch.ops import search as S
    from mp3tpu_torch.runtime.wav import read_wav
    from mp3tpu_torch.tables import mpeg

    ptxas = phase_build(k1, K, R, A12, P12)
    kres = phase_kernel(k1, torch)

    ctx = dict(np=np, torch=torch, k1=k1, K=K, S=S, R=R, E=E, loop=loop,
               A12=A12, P12=P12, alloc12_ptxas=ptxas[A12],
               graphs=graphs, EncoderConfig=EncoderConfig, mpeg=mpeg,
               encode=encode_layer3_fast, decode_mp3=decode_mp3,
               snr_db=snr_db, read_wav=read_wav, make_signal=make_signal,
               streams={})

    def cfg_of():
        return EncoderConfig(layer=3, mode=mpeg.MODE_STEREO,
                             bitrate_kbps=128, sample_rate_hz=44100)

    # ---- the main path: 60 s stereo 44.1 kHz 128 kbps
    pcm = make_signal(CLIP_SECONDS, 44100)
    main_searches = capture_main_searches(ctx, pcm, cfg_of())
    t0 = time.perf_counter()
    bres = phase_bits_at(ctx, first_evaluation(
        main_searches[4096]["stepsize"]))
    print(f"phase 3b bits_at: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    sres = phase_search(ctx, main_searches)
    print(f"phase 3c K3: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    rres = phase_resv(ctx, pcm, cfg_of())
    print(f"phase 3d K4: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    phase_quality()
    print(f"phase 4 quality: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    main_res = phase_main(ctx, pcm, cfg_of(), line)
    print(f"phase 5 main path: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    phase_graphs(ctx, pcm, cfg_of(), line, main_res["out"])
    print(f"phase 5b the rate loop as CUDA graphs: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    seg_res = phase_segment_graphs(ctx, pcm, cfg_of(), line, main_res["out"])
    print(f"phase 5c the segment program as CUDA graphs: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    phases = [("6 LSF", lambda: phase_lsf(ctx)),
              ("7 streaming", lambda: phase_stream(ctx, pcm, cfg_of)),
              ("8 Layers I/II", lambda: phase_layer12(ctx)),
              ("9 CLI", lambda: phase_cli(ctx, pcm, cfg_of)),
              ("10 corpus", lambda: phase_corpus(ctx, line, cfg_of)),
              ("11 multi-device", lambda: phase_sharded(ctx, cfg_of, line)),
              ("12 tooling", lambda: phase_tooling(ctx, pcm, cfg_of,
                                                   main_res["out"])),
              ("13 benchmark tools", lambda: phase_bench(
                  main_res["out"], counts["10 corpus"]["batch2_outs"],
                  line)),
              # last: it empties the graph caches
              ("14 threaded corpus",
               lambda: phase_threaded_corpus(ctx, line))]
    counts = {}
    for name, run in phases:
        t0 = time.perf_counter()
        counts[name] = run()
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    corpus, sharded = counts["10 corpus"], counts["11 multi-device"]
    print(f"bits_at on the corpus path's 32,768-lane batch: max_abs_err "
          f"{corpus['max_abs_err']}, {corpus['ms']} ms against the plain "
          f"chain's {corpus['plain_ms']} ms and a bound of "
          f"{corpus['bound_ms']:.6f} ms ({corpus['bound_by']}); on the "
          f"sharded path's batches: max_abs_err {sharded['max_abs_err']}",
          flush=True)
    k3 = corpus["search"]
    print(f"K3 on the corpus path's 32,768-lane stepsize search: max_abs_err "
          f"{corpus['search_max_abs_err']}, {k3['ms']} ms against the plain "
          f"search's "
          f"{k3['plain_ms']} ms ({k3['plain_launches']} bits_at launches) "
          f"and a bound of {k3['bound_ms']:.6f} ms ({k3['bound_by']}); on the "
          f"sharded path's: max_abs_err {sharded['search_max_abs_err']}",
          flush=True)

    launches = main_res["launches"]

    def by_path(kernel, warm=False):
        runs = {"main": main_res["warm"] if warm else launches,
                "lsf": counts["6 LSF"], "stream": counts["7 streaming"],
                "corpus": corpus["launches"], "sharded": sharded["launches"]}
        return {path: (c["warm"] if warm and path != "main" else c)[kernel]
                for path, c in runs.items()}

    kernels = ("search", "bits_at", "resv_scan", "alloc12", "pack12")
    for kernel in kernels + ("iterations", "captures", "replays") + tuple(
            f"{s}_{kind}" for s in ONE_GRAPH_STAGES + SEGMENT_STAGES
            + SHARDED_ANALYSIS for kind in ("captures", "replays")):
        what = {"iterations": "live rate-loop iterations per encode",
                "captures": "graph captures",
                "replays": "graph replays"}.get(
                    kernel, "launches" if kernel in kernels else "graphs")
        print(f"{kernel} {what} by path (first run): {by_path(kernel)}",
              flush=True)
    for kind, name in WAITS.items():
        print(f"host waits by path, {name} (one warm run: an encode, the "
              f"stream's 60 s, the corpus's 2 groups): "
              f"{by_path(kind, warm=True)}", flush=True)

    l12 = counts["8 Layers I/II"]
    l2, l1 = (l12["cells"][c[0]] for c in L12_CELLS)

    def l12_row(name, key, source, replaces, err):
        k, k1 = l2[key], l1[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": l2["launches"][name], "max_abs_err": err,
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None, "launches_by_path": dict(
                    by_path(name), layer2=l2["launches"][name],
                    layer1=l1["launches"][name],
                    layer2_stream=l2["windows"].get(name, 0)),
                "call_ms": k["call_ms"], "layer1_ms": k1["ms"],
                "layer1_plain_ms": k1["plain_ms"],
                "layer1_bound_ms": k1["bound_ms"],
                **({"steps": k["steps"], "layer1_steps": k1["steps"]}
                   if "steps" in k else {})}

    err, k_ms, p_ms, (b_ms, b_by) = kres[4096]
    print(json.dumps({"kernels": [
        {"name": "hist_c1", "route": "cuda",
         "source": "mp3tpu_torch/csrc/hist_c1.cu",
         "replaces": "mp3tpu/ops/pallas_bits.py:69",
         "launches": launches["hist_c1"], "max_abs_err": err,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None, "launches_by_path": dict(
             by_path("hist_c1"),
             main_k1_chain=main_res["by_way"]["k1"]["hist_c1"])},
        {"name": "bits_at", "route": "cuda",
         "source": "mp3tpu_torch/csrc/bits_at.cu",
         "replaces": "mp3tpu/ops/pallas_bits.py:69",
         "launches": launches["bits_at"],
         "max_abs_err": max(bres["max_abs_err"], corpus["max_abs_err"],
                            sharded["max_abs_err"]),
         "ms": bres["ms"], "plain_ms": bres["plain_ms"],
         "bound_ms": bres["bound_ms"], "bound_by": bres["bound_by"],
         "library_ms": None, "launches_by_path": dict(
             by_path("bits_at"),
             main_plain_searches=main_res["by_way"]["pr5"]["bits_at"])},
        {"name": "search", "route": "cuda",
         "source": "mp3tpu_torch/csrc/bits_at.cu",
         "replaces": "mp3tpu/ops/jaxloop.py:528-613",
         "launches": launches["search"],
         "max_abs_err": max(sres["max_abs_err"],
                            corpus["search_max_abs_err"],
                            sharded["search_max_abs_err"]),
         "ms": sres["ms"], "plain_ms": sres["plain_ms"],
         "bound_ms": sres["bound_ms"], "bound_by": sres["bound_by"],
         "library_ms": None, "launches_by_path": by_path("search"),
         "width": sres["width"], "runs": sres["runs"], "evals": sres["evals"],
         "encode_ms": main_res["k3_encode_ms"]},
        {"name": "resv_scan", "route": "cuda",
         "source": "mp3tpu_torch/csrc/resv_scan.cu",
         "replaces": "mp3tpu/ops/jaxresv.py:29-72",
         "launches": launches["resv_scan"],
         "max_abs_err": rres["max_abs_err"], "ms": rres["ms"],
         "plain_ms": rres["plain_ms"], "bound_ms": rres["bound_ms"],
         "bound_by": rres["bound_by"], "library_ms": None,
         "launches_by_path": by_path("resv_scan"),
         "design_floor_ms": rres["floor_ms"],
         "kernel_ms": rres["kernel_ms"], "chunk": rres["chunk"],
         "ns_per_granule": rres["ns_per_granule"],
         "ms_by_width": {str(k): v["ms"]
                         for k, v in rres["by_width"].items()},
         "parent_ms_by_width": {str(k): v.get("parent_ms")
                                for k, v in rres["by_width"].items()}},
        l12_row("alloc12", "k5", "mp3tpu_torch/csrc/alloc12.cu",
                "mp3tpu/runtime/alloc12.py:148", l12["k5_err"]),
        l12_row("pack12", "k6", "mp3tpu_torch/csrc/pack12.cu",
                "mp3tpu/runtime/bitstream.py:181", l12["k6_err"])]}),
          flush=True)
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                     sys.argv[5])
    else:
        if sys.argv[1:2] == ["--parent-tree"]:
            PARENT_TREE = os.path.abspath(sys.argv[2])
        main()
