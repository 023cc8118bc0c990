"""Per-stage attribution of the Layer III one-shot encode (counterpart of
``tools/trace_stages.py``).

The encode is asynchronous: a host clock around a stage measures its
enqueue unless the device is synchronized after it.  So each stage is
measured in isolation with ``torch.cuda.synchronize()`` after it (the
JAX tool's honest sync was a scalar ``device_get``), beside the real
end-to-end wall, this card's link (10 MiB host-to-device pageable and
pinned, device-to-host, a synchronize round trip) and the host cost of
one tiny eager launch, the figure that bounds an encode of thousands of
host dispatches (kernel launches, copies, memsets, CUDA graph launches;
``span_breakdown`` counts them by span).  Each stage also gets its
device kernels and copies and their busy time from torch.profiler.

    python -m mp3tpu_torch.tools.trace_stages [--device cuda|cpu]
        [--seconds 60] [--runs 5] [--trace DIR] [out.json]

``--trace DIR`` writes ``DIR/trace.json`` (``runtime.profiling.trace``)
of one more encode and adds its breakdown by named span
(``span_breakdown``).  Prints the report as JSON on stdout; writes
``out.json`` only when given.
"""
import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ..config import EncoderConfig
from ..encoder import (PAYLOAD_WORDS, RELAX_DELTA, _Layer3Framing,
                       _plan_segments, encode_layer3_fast, fill_granules)
from ..models.layer3 import final_budgets
from ..ops import graphs, resv
from ..runtime.profiling import SPANS, trace
from ..tables import mpeg
from . import DEVICE_CATS, describe, device_or_exit, profile_once, sync
from .signals import make_signal

MIB10 = 10 << 20
#: host calls that enqueue device work (their "correlation" names it)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the CUDA API calls that put work on a stream (kernel and graph
#: launches, copies, memsets), by a part of their name
DISPATCH_WORDS = ("Launch", "Memcpy", "Memset")


def med(f, n=3):
    """Median host seconds of f(i) for i < n."""
    ts = []
    for i in range(n):
        t0 = time.perf_counter()
        f(i)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def link_figures(dev, n=5):
    """This card's link and launch costs, host clock, median of n: 10 MiB
    of int16 up from pageable and from pinned memory, down into pageable
    and into pinned memory, one synchronize with nothing queued, one tiny
    launch + synchronize, and the host cost of one tiny eager launch
    (the host time of 2,000 in a row, before the synchronize)."""
    big = np.random.RandomState(0).randint(-1000, 1000, MIB10 // 2,
                                           dtype=np.int16)
    host = torch.from_numpy(big)
    pinned = host.pin_memory()
    on_dev = host.to(dev)
    back = torch.empty_like(host, pin_memory=True)
    sync(dev)

    def up(src, **kw):
        src.to(dev, **kw)
        sync(dev)

    def down_pinned(_):
        back.copy_(on_dev, non_blocking=True)
        sync(dev)

    tiny = torch.zeros(8, device=dev)
    launches = 2000

    def enqueue():
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(launches):
            tiny.add_(1.0)
        t1 = time.perf_counter()
        sync(dev)
        return t1 - t0

    t_up = med(lambda i: up(host), n)
    t_up_pinned = med(lambda i: up(pinned, non_blocking=True), n)
    t_down = med(lambda i: on_dev.cpu(), n)
    t_down_pinned = med(down_pinned, n)
    t_sync = med(lambda i: sync(dev), 20)
    t_round = med(lambda i: (tiny.add_(1.0), sync(dev)), 20)
    enqueue()
    t_launch = statistics.median(enqueue() for _ in range(n)) / launches
    return {
        "upload_10MiB_pageable_s": t_up,
        "upload_10MiB_pinned_s": t_up_pinned,
        "download_10MiB_pageable_s": t_down,
        "download_10MiB_pinned_s": t_down_pinned,
        "upload_pageable_GB_per_s": MIB10 / t_up / 1e9,
        "upload_pinned_GB_per_s": MIB10 / t_up_pinned / 1e9,
        "download_pageable_GB_per_s": MIB10 / t_down / 1e9,
        "download_pinned_GB_per_s": MIB10 / t_down_pinned / 1e9,
        "synchronize_idle_s": t_sync,
        "launch_and_synchronize_s": t_round,
        "host_s_per_tiny_launch": t_launch,
    }


def span_breakdown(path, names=SPANS):
    """The encode in a ``trace()`` file by named span: for each name its
    instances, their summed host wall (inclusive, and "self": less the
    spans nested in them), the device events (kernels, copies, memsets)
    whose launching host call lies inside it, with their summed device
    time, and the host dispatches inside it (CUDA API calls that launch
    a kernel or a CUDA graph, copy or set memory:
    ``DISPATCH_WORDS``), each inclusive and "self" (those of no nested
    span).  A replayed CUDA graph is one dispatch, and each of its
    kernels a device event linked to it.

    Returns {"spans": {name: {...}}, "device_events": all device events
    (DEVICE_CATS), "host_dispatches": all dispatches, "graph_launches":
    the CUDA graph launches among them, "device_events_by_cat": their
    count by category,
    "device_s": their summed time, "unlinked_events": device events whose
    launching call the trace does not hold, "copy_calls_without_event":
    copy and memset calls with no device event in the trace,
    "bits_at_kernel_events", "search_kernel_events",
    "resv_kernel_events": the device events of the bits_at and K3 kernels
    and of K4's two}."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] in names),
                   key=lambda e: (e["ts"], -e["dur"]))
    # each span's innermost enclosing span
    parent, stack = [], []
    for i, s in enumerate(spans):
        while stack and spans[stack[-1]]["ts"] + spans[stack[-1]]["dur"] \
                < s["ts"] + s["dur"]:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    out = {n: {"count": 0, "host_s": 0.0, "self_host_s": 0.0,
               "device_events": 0, "device_s": 0.0,
               "self_device_events": 0, "self_device_s": 0.0,
               "host_dispatches": 0, "self_host_dispatches": 0}
           for n in names}
    for i, s in enumerate(spans):
        rec = out[s["name"]]
        rec["count"] += 1
        rec["host_s"] += s["dur"] / 1e6
        rec["self_host_s"] += s["dur"] / 1e6
        if parent[i] is not None:
            out[spans[parent[i]]["name"]]["self_host_s"] -= s["dur"] / 1e6
    starts = [s["ts"] for s in spans]

    def holding(ts):
        """The spans holding host time ts, innermost first."""
        j = int(np.searchsorted(starts, ts, side="right")) - 1
        while j >= 0 and spans[j]["ts"] + spans[j]["dur"] < ts:
            j = parent[j] if parent[j] is not None else -1
        while j is not None and j >= 0:
            yield out[spans[j]["name"]]
            j = parent[j]

    unlinked = 0
    for e in device:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            unlinked += 1
            continue
        for depth, rec in enumerate(holding(ts)):
            rec["device_events"] += 1
            rec["device_s"] += e["dur"] / 1e6
            if depth == 0:
                rec["self_device_events"] += 1
                rec["self_device_s"] += e["dur"] / 1e6
    dispatches = [e for e in events if e.get("cat") in LAUNCH_CATS
                  and any(w in e["name"] for w in DISPATCH_WORDS)]
    for e in dispatches:
        for depth, rec in enumerate(holding(e["ts"])):
            rec["host_dispatches"] += 1
            if depth == 0:
                rec["self_host_dispatches"] += 1
    linked = {e.get("args", {}).get("correlation") for e in device}
    return {"spans": out, "device_events": len(device),
            "host_dispatches": len(dispatches),
            "graph_launches": sum("GraphLaunch" in e["name"]
                                  for e in dispatches),
            "device_events_by_cat": {c: sum(e["cat"] == c for e in device)
                                     for c in DEVICE_CATS},
            "device_s": sum(e["dur"] for e in device) / 1e6,
            "unlinked_events": unlinked,
            "copy_calls_without_event": sum(
                ("Memcpy" in e["name"] or "Memset" in e["name"])
                and e.get("args", {}).get("correlation") not in linked
                for e in events if e.get("cat") in LAUNCH_CATS),
            "bits_at_kernel_events": sum(
                "bits_at_kernel(" in e["name"] for e in device),
            "search_kernel_events": sum(
                "search_kernel(" in e["name"] for e in device),
            "resv_kernel_events": sum(
                "resv_map_kernel<" in e["name"]
                or "resv_walk_kernel<" in e["name"] for e in device)}


def isolated_stages(L3, pcm, dev):
    """Each stage of the first segment, cut as the one-shot encode cuts
    it, in isolation with a synchronize after it (median of 3 host
    seconds), and its device events and busy seconds from torch.profiler
    (None on the CPU)."""
    nch, mode_gr = L3.nch, L3.mode_gr
    pcm, nframes = L3.frame(pcm)
    G = nframes * mode_gr
    plan = _plan_segments(G)
    _, n_real, n_pad = plan[0]
    bl = np.zeros((nch, 4 + n_pad, 576), np.int16)
    fill_granules(bl[:, :4 + n_real], pcm, -4)
    fsm0 = torch.zeros(nch, dtype=torch.int32, device=dev)

    def demand(i):
        b = bl.copy()
        b[0, 4, i % 576] += 1          # a fresh host input every call
        a = L3.enc.analyze_demand_fused(torch.as_tensor(b, device=dev), fsm0)
        sync(dev)
        return a

    ana = demand(999)
    pe = resv.granule_major(ana["pe"].reshape(nch, -1), nch, mode_gr)
    dem = ana["p23"].reshape(nch, -1)
    valid_f = torch.arange(n_pad // mode_gr, device=dev) < n_real // mode_gr

    def scan(i):
        # as Layer3SegmentEncoder.forward calls it
        r = resv.scan_budgets(pe, resv.granule_major(dem, nch, mode_gr), 0,
                              L3.mean_bits, L3.resv_max, mode_gr, nch,
                              RELAX_DELTA, valid=valid_f)
        sync(dev)
        return r

    _, row = final_budgets(dem, scan(0)[0], n_real, nch, mode_gr)

    def final(i):
        h = L3.enc.encode_final(
            ana["xr"], ana["ratio_l"], ana["ratio_s"], ana["block_type"],
            row, payload_words=PAYLOAD_WORDS, scfsi=ana.get("scfsi"),
            sf_fix=ana.get("sf_fix"), nch=nch, qss_lo=ana["qss"],
            flat_cap=L3.cap(n_pad))
        sync(dev)
        return h

    h = final(0)

    def download(i):
        L3.fetch([h], ("side", "payload"))

    stages = {
        "analyze_demand_fused (1st segment, incl upload)": demand,
        "reservoir scan (resv.scan_budgets)": scan,
        "encode_final (device inputs)": final,
        "download side + compacted payload (fetch)": download,
    }
    times = {k: med(f) for k, f in stages.items()}
    device = None
    if dev.type == "cuda":
        device = {}
        for k, f in stages.items():
            events, busy, _ = profile_once(lambda: f(0))
            device[k] = {"device_events": len(events), "device_busy_s": busy}
    return times, device, plan, G


def run(seconds, device, runs=5, trace_dir=None):
    """The report for the bench signal of `seconds` on `device`."""
    dev = torch.device(device)
    rate = 44100
    pcm = make_signal(seconds, rate)

    def cfg():
        return EncoderConfig(layer=3, mode=mpeg.MODE_STEREO,
                             bitrate_kbps=128, sample_rate_hz=rate)

    def encode():
        out = encode_layer3_fast(pcm, cfg(), device=dev)
        sync(dev)
        return out

    t0 = time.perf_counter()
    out = encode()
    warmup_s = time.perf_counter() - t0
    e2e = []
    graphs.reset_counts()
    for _ in range(runs):
        t0 = time.perf_counter()
        encode()
        e2e.append(time.perf_counter() - t0)
    e2e_s = statistics.median(e2e)
    by_stage = graphs.by_stage()

    times, stage_device, plan, G = isolated_stages(_Layer3Framing(cfg(), dev),
                                                   pcm, dev)
    report = {
        "signal_s": seconds,
        "device": describe(dev),
        "bytes": len(out),
        "warmup_s": warmup_s,
        "e2e_median_s": e2e_s,
        "e2e_runs_s": e2e,
        "e2e_x_realtime": seconds / e2e_s,
        "graphs_by_stage": by_stage,
        "link": link_figures(dev) if dev.type == "cuda" else None,
        "stage_isolated_s": times,
        "stage_device": stage_device,
        "plan": plan,
        "granules": G,
        "segments": len(plan),
        "trace": None,
        "note": ("stages measured in isolation on the first segment, each "
                 "followed by a synchronize (host wall, median of 3); the "
                 "encode runs them in order per segment, so the sum over "
                 "segments, not one segment, compares with e2e; link "
                 "figures are host clock, median of 5 (None on the CPU); "
                 "device events and busy time from torch.profiler (None "
                 "on the CPU); graphs_by_stage: CUDA graph (captures, "
                 "replays) by stage over the timed encodes (none on the "
                 "CPU)"),
    }
    if trace_dir:
        with trace(trace_dir, dev):
            t0 = time.perf_counter()
            encode()
            wall = time.perf_counter() - t0
        path = os.path.join(trace_dir, "trace.json")
        report["trace"] = dict(span_breakdown(path), path=path,
                               traced_wall_s=wall)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mp3tpu_torch.tools.trace_stages",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--runs", type=int, default=5,
                    help="timed end-to-end encodes after one warm-up")
    ap.add_argument("--trace", metavar="DIR",
                    help="write DIR/trace.json of one more encode")
    ap.add_argument("out", nargs="?", help="also write the report here")
    args = ap.parse_args(argv)
    dev = device_or_exit("trace_stages", args.device)
    report = run(args.seconds, dev, args.runs, args.trace)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
