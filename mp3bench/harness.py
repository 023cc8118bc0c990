"""One run of one cell: set-up, the measured window, the trace, the
check, and the result line (``run.py`` is the command).

Set-up makes the cell's PCM from the seed, loads the port and encodes
each job of the cell's cycle once, so that every library is built and
every CUDA graph that the cycle needs is captured before the window.  The window is a closed loop, one job in flight as
one transcoding worker runs it: the next job starts when the previous
one's bytes are on the host, until the window's seconds are up; the
window ends with its last job.  A job's latency runs from its call to
its bytes on the host.
"""
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: modules that must not be loaded in a run, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "mp3tpu")
#: the window's rate is printed by slices of about this many seconds
SLICE_S = 2.5
#: the port's build and kernel caches, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec():
    return load_json(ROOT, "BENCHMARK.json")


def cell(bench, name):
    """(workload, configuration, traffic) of the cell `name`."""
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return (work, load_json(ROOT, conf["file"]),
            load_json(HERE, "traffic", work["traffic"] + ".json"))


def load_file(kind, name):
    """The module ``<kind>/<name>.py`` of the benchmark, by path (names
    may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    sp = importlib.util.spec_from_file_location(
        f"mp3bench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def entry(name):
    return importlib.import_module(f"mp3bench.entries.{name}")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Cycle:
    """The cell's jobs.  Each kind of job is a list of clips of fixed
    lengths, each a slice of one programme signal of `master_s` seconds
    made from the seed.  The cycle runs `passes` passes over the kinds,
    then starts again.  Clip c of kind k has a place (its index over all
    kinds' clips); in pass p it starts at place x `offset_step_s` + p x
    `pass_step_s`, wrapped into the master signal: each pass encodes
    other music of the same lengths, so a run averages over many
    slices, whatever the seed.  Set-up encodes every job of the cycle
    once, so the window meets no content whose path (a guard retry's
    graphs) was not warmed."""

    def __init__(self, traffic, config, seed, device):
        from .signals import programme
        per = traffic.get("clips_per_job", 1)
        self.step = traffic["offset_step_s"]
        self.pass_step = traffic.get("pass_step_s", 0.0)
        self.passes = traffic.get("passes", 1)
        self.rate = rate = config["sample_rate_hz"]
        self.kinds, places = [], 0
        for secs in traffic["job_seconds"]:
            self.kinds.append([(places + c, int(round(secs * rate)))
                               for c in range(per)])
            places += per
        longest = max(n for k in self.kinds for _, n in k)
        if traffic["master_s"] * rate < longest:
            raise ValueError("master_s is shorter than the longest clip")
        self.master = programme(seed, traffic["master_s"], rate, device,
                                nch=config["channels"],
                                **traffic.get("signal", {}))
        self.audio_s = [sum(n for _, n in k) / rate for k in self.kinds]

    def clips(self, k, p=0):
        """The clips of kind `k` in pass `p` of the cycle."""
        out = []
        for place, n in self.kinds[k]:
            room = self.master.shape[1] - n + 1
            off = int(round((place * self.step + p * self.pass_step)
                            * self.rate)) % room
            out.append(self.master[:, off: off + n])
        return out


def _nvidia_smi():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
        return float(r.stdout.strip().splitlines()[0].split(", ")[1])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(name, seed, seconds, trace, device="cuda", t_start=None,
        bench=None, log=None, edit=None, control=False):
    """One run of cell `name`: returns the result line's dict (the check
    numbers under "check", last).  `device` "cpu" runs the kernels' plain
    versions and `edit(traffic, config)` changes the cell's files as
    loaded; both are for tests only (a CPU run reports no device
    metric).  `control` also judges the control -- the plain reference
    in bfloat16 put in the program's place -- on the same sampled
    streams and reports its numbers under "control", before "check":
    the readings that the check's limits are set from."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or sys.stderr
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
    bench = bench or spec()
    work, config, traffic = cell(bench, name)
    if edit is not None:
        edit(traffic, config)
    split = {}
    t = time.perf_counter()
    import torch
    import mp3tpu_torch  # noqa: F401  (turns TF32 off)
    from mp3tpu_torch.ops import graphs
    from . import check
    split["import_s"] = time.perf_counter() - t
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < work["chips"]:
            raise SystemExit(f"{name} needs {work['chips']} CUDA device(s); "
                             f"torch sees {torch.cuda.device_count()}")
        t = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device=device)
        split["context_s"] = time.perf_counter() - t
    dev = torch.device(device)

    t = time.perf_counter()
    cyc = Cycle(traffic, config, seed, dev)
    if dev.type == "cuda":
        # the peak is the program's: the signal's making is not counted
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    split["pcm_s"] = time.perf_counter() - t
    encode = entry(traffic["entry"]).make(config, device,
                                          traffic.get("args", {}))
    t = time.perf_counter()
    for p in range(cyc.passes):
        for k in range(len(cyc.kinds)):
            encode(cyc.clips(k, p))
            if "first_job_s" not in split:
                split["first_job_s"] = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    split["warmup_s"] = time.perf_counter() - t
    split["captures"] = sum(c["captures"] for c in graphs.graph_counts.values())

    # ---- the window
    rng = np.random.default_rng([seed, 1])
    keep = traffic["check"]["jobs"]
    kept, longest = [], None                         # [(kind, pass, outs)]
    long_kind = int(np.argmax(cyc.audio_s))
    n_ok, audio, failed, traced, waits = 0, 0.0, 0, [], []
    prof = counts0 = t_traced = None
    if trace:
        # the window's first job warms the profiler up and is not
        # recorded; the jobs after it are, for `trace_seconds` or more
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function, schedule)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts,
                       schedule=schedule(wait=0, warmup=1, active=1 << 30))
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    from mp3tpu_torch import encoder as port_encoder
    retries0 = port_encoder.retry_fetches
    captures0 = sum(c["captures"] for c in graphs.graph_counts.values())
    slices = []                         # [start s, end s, audio s]
    t0 = time.perf_counter()
    i, te = 0, t0
    while i == 0 or te - t0 < seconds or (prof is not None and not traced):
        k, p = i % len(cyc.kinds), i // len(cyc.kinds) % cyc.passes
        clips = cyc.clips(k, p)
        ts = time.perf_counter()
        try:
            if prof is not None:
                with record_function("mp3bench.job"):
                    outs = encode(clips)
            else:
                outs = encode(clips)
        except Exception as e:                       # a failed job counts
            print(f"job {i} failed: {e!r}", file=log)
            failed, outs = failed + 1, None
        te = time.perf_counter()
        if outs is not None:
            n_ok += 1
            audio += cyc.audio_s[k]
            waits.append(te - ts)
            if not slices or slices[-1][1] - slices[-1][0] >= SLICE_S:
                start = slices[-1][1] if slices else 0.0
                slices.append([start, start, 0.0])
            slices[-1][1:] = te - t0, slices[-1][2] + cyc.audio_s[k]
            if n_ok <= keep:
                kept.append((k, p, outs))
            else:                                    # a reservoir sample
                j = int(rng.integers(0, n_ok))
                if j < keep:
                    kept[j] = (k, p, outs)
            if k == long_kind and longest is None:
                longest = (k, p, outs)
            if prof is not None and t_traced is not None:
                traced.append((k, outs))
        if prof is not None:
            if t_traced is None:                     # the warm-up job
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof.step()
                counts0 = {s: dict(c) for s, c in graphs.graph_counts.items()}
                t_traced = time.perf_counter()
            elif te - t_traced >= traffic["trace_seconds"]:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof.__exit__(None, None, None)
                counts1 = {s: dict(c) for s, c in graphs.graph_counts.items()}
                done_prof, prof = prof, None
        i += 1
    window_s = te - t0
    print(f"window: {window_s} s, {i} jobs, {audio} s of audio; rate by "
          f"slice of about {SLICE_S} s: "
          + ", ".join(f"{a / (e - b):.1f}x" for b, e, a in slices)
          + f"; settle's retries {port_encoder.retry_fetches - retries0}, "
          f"graph captures "
          f"{sum(c['captures'] for c in graphs.graph_counts.values()) - captures0}"
          f", load average {os.getloadavg()}", file=log)
    if prof is not None:                             # the window was short
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
        counts1 = {s: dict(c) for s, c in graphs.graph_counts.items()}
        done_prof = prof
    result = dict(correct=False, attempted=i, failed=failed, metrics={})
    if dev.type == "cuda":
        result["device"] = dict(
            platform="gpu", kind=torch.cuda.get_device_name(dev), count=1,
            memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)),
            power_limit_w=_nvidia_smi())
    else:
        result["device"] = dict(platform="cpu", kind="cpu", count=0,
                                memory_peak_bytes=0)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded in the run: {', '.join(bad)}")

    if not trace:
        unit = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        vals = dict(setup_s=setup_s, audio_rtf=audio / window_s,
                    job_p95_ms=1e3 * float(np.percentile(waits, 95))
                    if waits else None)
        for m in bench["end_to_end"]:
            if name in m.get("workloads", [name]):
                result["metrics"][m["name"]] = dict(value=vals[m["name"]],
                                                    unit=unit[m["name"]])
    else:
        per_layer(result, bench, name, config, done_prof, traced, cyc,
                  counts0, counts1, dev)

    # ---- the check, once the window has closed and the peak is read
    del encode
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if longest is not None and all(k != long_kind for k, _, _ in kept):
        kept.append(longest)
    pairs = [(pcm, out) for k, p, outs in kept
             for pcm, out in zip(cyc.clips(k, p), outs)]
    t = time.perf_counter()
    res = check.judge(config, pairs, traffic["check"]["frames"], [seed, 2])
    ok, rows = check.verdict(res, config["limits"])
    result["correct"] = bool(ok and failed == 0 and i > 0)
    print(f"setup split: " + ", ".join(f"{k} {v}" for k, v in split.items()),
          file=log)
    if config["layer"] == 3 and res["granules"]:
        print(f"traffic: {res['short']} of {res['granules']} granules of the "
              f"checked streams in short blocks "
              f"({100.0 * res['short'] / res['granules']}%)", file=log)
    print(f"check: {len(pairs)} streams, {res['compared']} values compared "
          f"in {time.perf_counter() - t} s; faults: {res['faults']}",
          file=log)
    if control:
        t = time.perf_counter()
        ctl = check.judge(config, pairs, traffic["check"]["frames"],
                          [seed, 2], control=True)
        result["control"] = {n: ctl.get(n) for n in config["limits"]}
        print(f"control: {result['control']} in {time.perf_counter() - t} s",
              file=log)
    for n, v, lim in rows:
        print(f"check {n} {v} limit {lim}", file=log)
    result["check"] = {n: dict(value=v, limit=lim) for n, v, lim in rows}
    return result


def per_layer(result, bench, name, config, prof, traced, cyc, counts0,
              counts1, dev):
    """The cell's per-layer metrics and the breakdown from the traced
    part of the window, and the device's busy and traced seconds."""
    from .trace import Trace
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        tr = Trace(path)
    ctx = SimpleNamespace(
        trace=tr, config=config, jobs=len(traced),
        audio_min=sum(cyc.audio_s[k] for k, _ in traced) / 60.0,
        streams=[s for _, outs in traced for s in outs],
        counters={s: {k: counts1[s][k] - counts0[s][k] for k in counts1[s]}
                  for s in counts1})
    unit = {m["name"]: m["unit"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        if name not in m.get("workloads", [name]):
            continue
        v = load_file("metrics", m["name"]).read(ctx)
        if v is not None:
            result["metrics"][m["name"]] = dict(value=v, unit=unit[m["name"]])
    if dev.type == "cuda":
        busy = sum(e - s for s, e in tr.busy())
        result["device"].update(busy_s=busy / 1e6, window_s=tr.window_us / 1e6)
        result["breakdown"] = tr.breakdown()
