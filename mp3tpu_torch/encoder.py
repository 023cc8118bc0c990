"""Encoders on PyTorch (port of mp3tpu/encoder.py).

Layer III, one shot (``encode_layer3_fast``): the PCM is cut into
super-chunk segments (``_plan_segments``); each segment runs one
``Layer3SegmentEncoder`` call -- analysis + demand encode -> reservoir
scan -> final encode + packing -- with the block-type automaton state
and the reservoir level carried from segment to segment as device
tensors.  Every segment is queued before the first download, as the
JAX package's one program chain is (``mp3tpu/encoder.py:206-225``).
Each segment's side table and compacted payload start for the host as
soon as the segment is queued (``_Layer3Framing.fetch_async``: a copy
into pinned memory on the copy stream, the JAX package's per-segment
``pool.submit(jax.device_get, ...)``, ``mp3tpu/encoder.py:352-356``),
and on the card the host waits once an encode, on the last segment's
copy (``Download.wait``).  Then the reservoir guard validates the
realized part2_3_length chain (clamp + re-encode on the rare overdraw)
and the native assembler (csrc/mp3bits.cpp) writes the stream.  MPEG-1
(32/44.1/48 kHz) and MPEG-2 LSF (16/22.05/24 kHz).

Layer III, streaming (``StreamEncoder``, ``encode_layer3_stream``): the
same segment program window by window (one wait a window), with the
carried state made explicit, so that it checkpoints to a small
picklable dict.

``fetches`` counts the host's waits for results (``Download.wait``), of which
``retry_fetches`` came from ``settle``'s rare retries; the rate loop's
exit syncs are ``ops/loop.any_on_host.syncs`` and the host scans'
downloads ``ops/resv.host_scans``.  ``float_frames`` counts the clips
framed through the float sanitizing path; an int16 clip is copied once,
from the caller's array into the segments' pinned buffers
(``fill_granules``).  A Layer I/II item is copied once too, into the
pinned buffer that is uploaded (``_layer12_frame``; float input counted
in ``float_frames_l12``).

Layers I/II (``encode_layer12_fast``, ``encode_layer12_stream``): one
chain queued on the device -- the analysis (one CUDA graph a frame
count on the card) and the quantizers (``ops/layer12.py``), the bit
allocation (K5, ``ops/alloc12.py``), the
element marshalling (``marshal_frames``) and the frame packing with the
CRC (K6, ``ops/pack12.py``) -- and one download an encode (a stream
window).

Every entry point takes an explicit ``device``.
"""
import math
import threading

import numpy as np
import torch

from .config import EncoderConfig
from .runtime import profiling
from .runtime.profiling import scope, span
from .runtime.bitstream import NativeAssembler, guard_clamp, resv_guard
from .tables import layer12 as T12
from .tables import mpeg

from . import resolve_device
from .models.layer3 import Layer3SegmentEncoder
from .ops import alloc12 as A12
from .ops import bits
from .ops import layer12 as L12
from .ops import pack12 as P12
from .ops import resv

#: super-chunk buckets (granules per channel per segment), as in the
#: JAX package, so that segments line up with it
SUPER_BUCKETS = (256, 1024, 2048)
#: chunk buckets (granules per channel per chunk) of the multi-rank path
#: (parallel/clip.py): each rank's share is cut into chunks of the
#: smallest bucket covering it
CHUNK_BUCKETS = (64, 128, 256)
#: predicted slack of reservoir-limited granules, folded into the scan
RELAX_DELTA = 28
#: initial payload row width in 32-bit words
PAYLOAD_WORDS = 96

#: downloads of results that the host waited for (``Download.wait``: one
#: a wait, however many downloads it reads; and the multi-rank path's)
fetches = 0
#: of ``fetches``, those of ``settle``'s rare retries (a wider payload row
#: or a guard clamp): one of the scan's targets and demands, and one for
#: each re-encode
retry_fetches = 0
#: Layer III clips that ``_Layer3Framing.frame`` took through the float
#: sanitizing path (any input that is not int16); counted under
#: ``_FLOAT_FRAMES_LOCK``, since ``encode_corpus`` frames from threads
float_frames = 0
#: Layer I/II items that ``_layer12_frame`` framed as float32 (any input
#: that is not int16), under the same lock
float_frames_l12 = 0
_FLOAT_FRAMES_LOCK = threading.Lock()


def pinned(shape, dtype, dev):
    """A zeroed host tensor to fill (``.numpy()``) and ``upload``: pinned
    for a CUDA device, so that its upload does not wait for the stream.
    It may be dropped as soon as the upload is queued: PyTorch's caching
    host allocator records an event on the copy's stream and reuses the
    block only once that event has completed."""
    return torch.zeros(shape, dtype=dtype, pin_memory=dev.type == "cuda")


def upload(host, dev):
    """`host` (from ``pinned``) on `dev`, its copy queued on the current
    stream; on the CPU, `host` itself."""
    return host.to(dev, non_blocking=True)


def fill_granules(dst, pcm, g0):
    """Copy granules [g0, g0 + n) of `pcm`, a clip as
    ``_Layer3Framing.frame`` gives it ((nch, samples) int16), into `dst`,
    an (nch, n, 576) int16 array (a segment's halo and blocks in a
    ``pinned`` buffer), with zeros where the range leaves the clip:
    before its first sample (g0 < 0, the first segment's halo) and past
    its last."""
    nch, n, _ = dst.shape
    lo = min(max(-g0, 0), n)
    a = (g0 + lo) * 576
    m = min(max(pcm.shape[1] - a, 0), (n - lo) * 576)
    k, r = divmod(m, 576)
    dst[:, :lo] = 0
    dst[:, lo:lo + k] = pcm[:, a:a + k * 576].reshape(nch, k, 576)
    hi = lo + k
    if r:
        dst[:, hi, :r] = pcm[:, a + k * 576:a + m]
        dst[:, hi, r:] = 0
        hi += 1
    dst[:, hi:] = 0


#: each CUDA device's copy stream (``copy_stream``)
_COPY_STREAMS = {}
_COPY_LOCK = threading.Lock()


def copy_stream(dev):
    """The stream on which results of `dev` are copied to the host: one
    a device, made on first use, so that its copies complete in the order
    in which they were queued, from every thread."""
    with _COPY_LOCK:
        if dev not in _COPY_STREAMS:
            _COPY_STREAMS[dev] = torch.cuda.Stream(device=dev)
        return _COPY_STREAMS[dev]


def queue_download(flat):
    """Queue the copy of the 1-d tensor `flat` to the host: on the card a
    pinned host tensor filled on the copy stream (``copy_stream``), which
    first waits for the caller's stream, and the event recorded after the
    copy; on the CPU `flat` itself and None.  Nothing here waits on the
    host.  `flat` is marked as in use on the copy stream
    (``record_stream``), so that the caching allocator gives its block to
    no later kernel of the caller's stream before the copy has run."""
    if flat.device.type != "cuda":
        return flat, None
    stream = copy_stream(flat.device)
    stream.wait_stream(torch.cuda.current_stream(flat.device))
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    flat.record_stream(stream)
    return host, done


class Download:
    """A queued copy of segment results to the host (``fetch_async``):
    the int32 host tensor it fills and, on the card, the event recorded on
    the copy stream after the copy (on the CPU the copy is made at once,
    and ``done`` is None).  ``layout`` holds each segment's (key, shape)
    pairs in the order of the flat tensor."""

    def __init__(self, layout, host, done):
        self.layout, self.host, self.done = layout, host, done

    @span("fetch")
    def wait(self, earlier=(), scan=False):
        """The host's one wait for this download and the `earlier` ones,
        queued before it on the same copy stream: this one's event is
        synchronized (the stream runs its copies in order, so the earlier
        ones are done then) and one fetch is counted (with `scan`, one
        host scan's download in ``ops/resv.host_scans``: the multi-rank
        path's scan inputs).  Returns the dicts
        of numpy values of every segment of `earlier` and then of this
        one, as ``_Layer3Framing.fetch`` does.

        A pinned buffer read before its copy has run gives stale bytes
        and no error, so an earlier download whose event has not
        completed raises instead."""
        global fetches
        if scan:
            resv.host_scans += 1
        else:
            fetches += 1
        if self.done is not None:
            self.done.synchronize()
        outs = []
        for d in (*earlier, self):
            if d.done is not None and not d.done.query():
                raise RuntimeError("a download was read before its copy "
                                   "completed")
            outs += d.read()
        return outs

    def read(self):
        """The segments' dicts of numpy values: views of the host tensor,
        the side table as int16, the payload as uint32 and n_nonfinite as
        an int.  Call it once the copy has completed (``wait``)."""
        flat = self.host.numpy()
        outs, pos = [], 0
        for layout in self.layout:
            out = {}
            for k, shape in layout:
                n = math.prod(shape)
                out[k] = flat[pos:pos + n].reshape(shape)
                pos += n
            if "side" in out:
                out["side"] = out["side"].astype(np.int16)
            if "payload" in out:
                out["payload"] = out["payload"].view(np.uint32)
            if "n_nonfinite" in out:
                out["n_nonfinite"] = int(out["n_nonfinite"])
            outs.append(out)
        return outs


def _plan_segments(G, buckets=SUPER_BUCKETS):
    """Greedy super-chunk plan [(start, n_real, n_padded)]: a small first
    segment (the smallest bucket) when the clip spans more than one big
    bucket, full largest-bucket segments, and one remainder padded to
    the smallest covering bucket.  Only the last segment is padded, so
    the carried state always comes from real granules."""
    plan = []
    pos = 0
    big = buckets[-1]
    ramp = buckets[0]
    if ramp < big and G > big + ramp:
        plan.append((0, ramp, ramp))
        pos = ramp
    while G - pos > big:
        plan.append((pos, big, big))
        pos += big
    rem = G - pos
    for b in buckets:
        if rem <= b:
            return plan + [(pos, rem, b)]
    return plan + [(pos, rem, big)]


def _chunk_size(G):
    """The smallest chunk bucket covering G granules (the largest when
    none does)."""
    for c in CHUNK_BUCKETS:
        if G <= c:
            return c
    return CHUNK_BUCKETS[-1]


@span("_stitch_flat")
def _stitch_flat(plan, seg_sides, seg_flats, nch, lane0=0, G=None):
    """Stitch per-segment compacted payloads into one clip-order flat
    buffer + per-granule word offsets for the native assembler.

    seg_sides: per segment (n_lanes*n_pad, 19) side tables (p23 at col
    0); seg_flats: per segment flat uint32 payloads in lane order.
    lane0: the clip's first channel lane within the segment lane axis.
    G: the clip's real granule count when SHORTER than the plan's
    coverage.  Tail granules past G are excluded from spans AND offsets
    together: they are not reliably silent (the MDCT overlap of the last
    real granule rings into the first padded one).
    Returns (clip_flat uint32, offsets (nch*G,) int64)."""
    spans = [[] for _ in range(nch)]
    for (pos, n_real, n_pad), side_s, flat in zip(plan, seg_sides,
                                                  seg_flats):
        clip_n = n_real if G is None else max(0, min(n_real, G - pos))
        if clip_n == 0:
            continue
        p23 = np.asarray(side_s)[:, 0].astype(np.int64)
        wlen = (p23 + 31) >> 5
        end = np.cumsum(wlen)
        off = end - wlen
        flat = np.asarray(flat)
        for ch in range(nch):
            lo = (lane0 + ch) * n_pad
            spans[ch].append((flat[off[lo]:end[lo + clip_n - 1]],
                              wlen[lo:lo + clip_n]))
    pieces = [p for ch in range(nch) for p, _ in spans[ch]]
    wlens = [w for ch in range(nch) for _, w in spans[ch]]
    clip_flat = (np.concatenate(pieces) if pieces
                 else np.zeros(0, np.uint32))
    wlen_clip = np.concatenate(wlens)
    offs = np.cumsum(wlen_clip) - wlen_clip
    return clip_flat, offs.astype(np.int64)


class _Layer3Framing:
    """What every Layer III path derives from the config: the frame's
    bit budget, the reservoir limit, and the segment program."""

    @span("_Layer3Framing")
    def __init__(self, cfg, device):
        cfg.finalize()
        if cfg.layer != 3:
            raise ValueError("this encoder encodes Layer III only")
        self.dev = resolve_device(device)
        self.nch = cfg.nchannels
        self.mode_gr = cfg.mode_gr
        self.spf = cfg.samples_per_frame
        self.bits_per_frame = 8 * cfg.slots_per_frame()[0]
        self.sideinfo_len = mpeg.sideinfo_bits(cfg.version, self.nch,
                                               cfg.error_protection)
        self.mean_bits = (self.bits_per_frame - self.sideinfo_len) \
            // self.mode_gr
        # main_data_begin is 9 bits in MPEG-1, 8 in LSF (reservoir.c:53-62)
        resv_limit = 4088 if self.mode_gr == 2 else 2040
        self.resv_max = min(max(0, 7680 - self.bits_per_frame), resv_limit)
        self.sfb_s = np.asarray(
            mpeg.sfb_short(cfg.version, cfg.sampling_frequency), np.int32)
        self.enc = Layer3SegmentEncoder(cfg.version, cfg.sampling_frequency,
                                        self.dev)

    @span("frame")
    def frame(self, pcm):
        """PCM (samples x channels, channels x samples, or 1-d mono) as
        (nch, n) int16 and nframes, the whole frames that cover its n
        samples; ``fill_granules`` copies it into a segment's blocks, zeros
        past its last sample.  Int16 input is returned as a view of the
        caller's samples, neither copied nor padded.  Any other input is
        sanitized into a new array (counted in ``float_frames``): NaN -> 0,
        +/-Inf -> full scale, clipped to the int16 range."""
        global float_frames
        pcm = np.atleast_2d(np.asarray(pcm))
        if pcm.shape[0] > pcm.shape[1]:
            pcm = pcm.T
        if pcm.shape[0] != self.nch:
            raise ValueError(
                f"pcm has {pcm.shape[0]} channels, config {self.nch}")
        nframes = -(-pcm.shape[1] // self.spf)
        if pcm.dtype != np.int16:
            with _FLOAT_FRAMES_LOCK:
                float_frames += 1
            pcm = np.clip(np.nan_to_num(pcm.astype(np.float32), nan=0.0,
                                        posinf=32767.0, neginf=-32768.0),
                          -32768, 32767).astype(np.int16)
        return pcm, nframes

    def cap(self, n_pad):
        """Flat payload buffer size of an n_pad-granule segment."""
        return bits.payload_cap_words(n_pad // self.mode_gr,
                                      self.bits_per_frame, self.sideinfo_len,
                                      self.resv_max, self.nch * n_pad)

    def segment(self, blocks_h4, fsm, size, pw, n_real, delta):
        """Queue the segment program on (nch, 4 + n_pad, 576) int16
        blocks, a tensor from ``pinned``; fsm and size, the
        carry, may be device tensors.  Returns its outputs on the device;
        nothing waits on the host once the graphs are captured."""
        n_pad = blocks_h4.shape[1] - 4
        with scope("upload"):
            blocks = upload(blocks_h4, self.dev)
        return self.enc(blocks, fsm, size, pw, self.nch, self.cap(n_pad),
                        n_real, self.mean_bits, self.resv_max, self.mode_gr,
                        delta)

    @span("fetch_async")
    def fetch_async(self, hs, keys=None):
        """Queue one device -> host copy of the results of the segments `hs`
        (a list of segment outputs): by default each one's side table
        (int16), compacted payload (uint32), n_nonfinite (int) and, for
        MPEG-1, scfsi flags.  Returns a ``Download``, whose ``wait()`` is
        the host's wait for them.

        The values go into one int32 tensor on the caller's stream.  On the
        card it is copied into a pinned host tensor on the copy stream
        (``copy_stream``), which first waits for the caller's stream; an
        event recorded after the copy marks it done.  Nothing here waits
        on the host.

        Buffer lifetime across streams: the copy reads the flat tensor on
        the copy stream after this call has dropped it, so it is marked as
        in use there (``record_stream``), and the caching allocator gives
        its block to no later kernel of the caller's stream before the
        copy has run.  The pinned tensor is the download's; the caching
        host allocator keeps its block from reuse until the copy's event
        has completed.  The segment tensors themselves are read on the
        caller's stream only."""
        want = [keys if keys is not None else
                ["side", "payload", "n_nonfinite"]
                + (["scfsi"] if "scfsi" in h else []) for h in hs]
        layout = [[(k, tuple(h[k].shape)) for k in ks]
                  for h, ks in zip(hs, want)]
        flat = torch.cat([h[k].reshape(-1).to(torch.int32)
                          for h, ks in zip(hs, want) for k in ks])
        return Download(layout, *queue_download(flat))

    def fetch(self, hs, keys=None):
        """``fetch_async(hs, keys).wait()``: the results of the segments
        `hs` as a list of dicts of numpy values, the host's one wait for
        them."""
        return self.fetch_async(hs, keys).wait()

    @span("scfsi_frames")
    def scfsi_frames(self, plan, got):
        """(nch, F, 4) scfsi flags of the real frames (zeros for LSF)."""
        if self.mode_gr == 1:
            nframes = sum(n_real for _, n_real, _ in plan)
            return np.zeros((self.nch, nframes, 4), np.int32)
        return np.concatenate([g["scfsi"][:, :n_real // 2]
                               for (_, n_real, _), g in zip(plan, got)],
                              axis=1)

    @span("settle")
    def settle(self, plan, segs, got, pw, nframes, size=None):
        """The dense encode is the authority on p23: (a) a granule can
        exceed its payload row -> re-bucket wider; (b) the reservoir guard
        can flag an overdraw -> clamp the budgets (cumulatively across
        retries) and re-encode.  size: the realized reservoir level
        carried into a stream window (None for a whole clip).
        Returns (side (nch, G, 19), payload (flat, offsets), p23, retries,
        the realized level after the frames or None)."""
        nch = self.nch

        def concat_real(parts):
            """per-segment (nch*n_pad, ...) -> (nch, G, ...) real granules."""
            return np.concatenate(
                [np.asarray(p).reshape((nch, n_pad) + np.shape(p)[1:])
                 [:, :n_real] for (_, n_real, n_pad), p in zip(plan, parts)],
                axis=1)

        def assemble(outs):
            return (concat_real([o["side"] for o in outs]),
                    _stitch_flat(plan, [o["side"] for o in outs],
                                 [o["payload"] for o in outs], nch))

        def scan_tensors():
            """The scan's (target, demand), real granules only: one
            fetch."""
            global retry_fetches
            retry_fetches += 1
            got = self.fetch(segs, ("target", "demand"))
            return tuple(
                np.concatenate([g[k][:, :n_real]
                                for (_, n_real, _), g in zip(plan, got)],
                               axis=1).astype(np.int64)
                for k in ("target", "demand"))

        @span("run_final")
        def run_final(pw, target, demand):
            """One re-encode of every segment at budgets min(target,
            demand): a re-bucket or a guard retry."""
            global retry_fetches
            retry_fetches += 1
            hs = []
            for (pos, n_real, n_pad), s in zip(plan, segs):
                with scope("upload"):
                    bh = pinned(nch * n_pad, torch.float32, self.dev)
                    t = target[:, pos: pos + n_real]
                    d = demand[:, pos: pos + n_real]
                    bh.numpy().reshape(nch, n_pad)[:] = 4095.0
                    bh.numpy().reshape(nch, n_pad)[:, :n_real] = \
                        np.where(t < d, t, 4095)
                    budget = upload(bh, self.dev)
                hs.append(self.enc.encode_final(
                    s["xr"], s["ratio_l"], s["ratio_s"], s["block_type"],
                    budget, payload_words=pw, scfsi=s.get("scfsi"),
                    sf_fix=s.get("sf_fix"), nch=nch, qss_lo=s["qss"],
                    flat_cap=self.cap(n_pad)))
            return assemble(self.fetch(hs, ("side", "payload")))

        side, payload = assemble(got)
        p23 = side[:, :, 0].astype(np.int64)
        scan = None
        while int(p23.max()) > 32 * pw:
            if pw >= bits.PAYLOAD_WORDS:
                raise RuntimeError("granule exceeds the maximum payload row")
            pw = min(bits.PAYLOAD_WORDS, pw + 32)
            with scope("rebucket"):
                scan = scan or scan_tensors()
                side, payload = run_final(pw, *scan)
            p23 = side[:, :, 0].astype(np.int64)
        for retry in range(4):
            res = resv_guard(p23, nframes, nch, self.mean_bits,
                             self.resv_max, self.mode_gr, size=size)
            bad, limits = res[0], res[1]
            if not bad:
                break
            if retry == 3:
                raise RuntimeError(
                    "reservoir guard failed on a guaranteed-feasible clamp")
            with scope("guard_retry"):
                target, demand = scan or scan_tensors()
                scan = (guard_clamp(target, limits, retry, self.mean_bits,
                                    nch), demand)
                side, payload = run_final(pw, *scan)
            p23 = side[:, :, 0].astype(np.int64)
        return side, payload, p23, retry, (res[2] if size is not None
                                           else None)

    @span("native assembly")
    def weave(self, asm, nframes, side, payload, scfsi):
        """Native frame loop (reservoir.c:141-226 + side-info emission +
        payload splice) of (nch, G, 19) side rows and their payload."""
        flat, offs = payload
        side = np.ascontiguousarray(np.asarray(side, np.int32))
        if side.shape != (self.nch, nframes * self.mode_gr, 19):
            raise ValueError(f"side table shape {side.shape}")
        # native layout: (nframes, nch, 4)
        scfsi_fm = np.ascontiguousarray(
            np.asarray(scfsi, np.int32).transpose(1, 0, 2))
        asm.encode_clip_payload(nframes, self.bits_per_frame, self.mean_bits,
                                self.resv_max, scfsi_fm, side,
                                np.ascontiguousarray(flat), row_offsets=offs)


def encode_layer3_fast(pcm, cfg: EncoderConfig, device, chunk=None,
                       delta=RELAX_DELTA, pw=PAYLOAD_WORDS, prof=None):
    """Encode int16 PCM (samples x channels, or channels x samples) to
    Layer III bytes on `device` ("cuda" or "cpu"; CUDA must be present
    when asked for).

    chunk: one super-chunk bucket for every segment (default: the
    SUPER_BUCKETS plan).  delta: predicted slack of reservoir-limited
    granules, folded into the budget scan.  pw: initial payload row
    width in 32-bit words (re-bucketed wider when a granule needs it).
    prof: a ``runtime.profiling`` sink (default: from the
    MP3TPU_PROFILE environment variable); its ``meta`` receives the
    per-encode metrics of the JAX package.
    """
    prof = prof if prof is not None else profiling.from_env()
    L3 = _Layer3Framing(cfg, device)
    nch, mode_gr = L3.nch, L3.mode_gr
    pcm, nframes = L3.frame(pcm)
    total = nframes * L3.spf
    G = nframes * mode_gr
    plan = _plan_segments(G, (chunk,) if chunk else SUPER_BUCKETS)

    # ---- one segment program per plan entry, state carried across on
    # the device; each segment's download queued behind it, then one wait
    # on the last: the copy stream completes its copies in order
    segs, downloads = [], []
    size = 0
    for pos, n_real, n_pad in plan:
        with scope("upload"):
            # the automaton's start state, queued inside the span: the
            # card's idle time behind it is this fill's
            if not pos:
                fsm = torch.zeros(nch, dtype=torch.int32, device=L3.dev)
            host = pinned((nch, 4 + n_pad, 576), torch.int16, L3.dev)
            fill_granules(host.numpy()[:, :4 + n_real], pcm, pos - 4)
        h = L3.segment(host, fsm, size, pw, n_real, delta)
        fsm, size = h["fsm_state"], h["size"]
        segs.append(h)
        downloads.append(L3.fetch_async([h]))
    got = downloads[-1].wait(earlier=downloads[:-1])

    side, payload, p23, retries, _ = L3.settle(plan, segs, got, pw, nframes)
    with scope("NativeAssembler"):
        asm = NativeAssembler(cfg, L3.sfb_s)
    L3.weave(asm, nframes, side, payload, L3.scfsi_frames(plan, got))
    with scope("NativeAssembler.finish"):
        out = asm.finish()
    # per-encode metrics, the keys of the JAX package's encode
    secs = total / L3.enc.sfreq_hz
    prof.meta.update(
        frames=nframes, bytes=len(out), audio_s=round(secs, 3),
        kbps=round(len(out) * 8 / max(secs, 1e-9) / 1000.0, 2),
        segments=len(plan), guard_retries=retries,
        nonfinite_granules=sum(g["n_nonfinite"] for g in got),
        mean_p23=float(p23.mean()), resv_delta=delta)
    return out


class StreamEncoder:
    """Streaming Layer III encoder: O(window) memory for an unbounded
    PCM stream.  The unit is a fixed window of granules, so every
    segment program is reused; the carried state is 4 halo PCM blocks,
    the (nch,) automaton state, the reservoir level of the budget scan
    and of the realized chain, and the native assembler's weave state.
    Windowed output equals the one-shot encode when the windows and the
    one-shot plan have the same segment shapes (``window == chunk``).
    ``checkpoint()`` gives a small dict of numpy and Python values, from
    which ``resume()`` continues the identical stream on any device."""

    def __init__(self, cfg: EncoderConfig, device, window=None):
        self.L3 = _Layer3Framing(cfg, device)
        # default: the one-shot plan's top bucket, so that remainder
        # windows decompose like the one-shot remainder
        self.window = window or SUPER_BUCKETS[-1]
        self.cfg = cfg
        self.nch = cfg.nchannels
        self.spf = cfg.samples_per_frame
        self.rem_buckets = (SUPER_BUCKETS
                            if self.window == SUPER_BUCKETS[-1]
                            else (self.window,))
        with scope("NativeAssembler"):
            self.asm = NativeAssembler(cfg, self.L3.sfb_s)
        self.fsm = torch.zeros(self.nch, dtype=torch.int32,
                               device=self.L3.dev)
        self.halo4 = np.zeros((self.nch, 4, 576), np.int16)
        # the budget scan's level: on the device once a window has run
        self.scan_size = 0
        self.real_size = 0        # the realized chain (guard + assembler)
        self.buf = np.zeros((self.nch, 0), np.int16)

    def feed(self, piece):
        """Accept PCM (int16, (n,) mono or (n, nch) or (nch, n)); returns
        the MP3 bytes of the frames completed so far."""
        piece = np.atleast_2d(np.asarray(piece, np.int16))
        # orient by channel count: a final (nch, 1) piece stays as it is
        if piece.shape[0] != self.nch:
            piece = piece.T
        if piece.shape[0] != self.nch:
            raise ValueError(f"piece of shape {piece.shape} for "
                             f"{self.nch} channels")
        self.buf = np.concatenate([self.buf, piece], axis=1)
        out = []
        ws = self.window * 576
        while self.buf.shape[1] >= ws:
            out.append(self._encode_window(self.buf[:, :ws], False))
            self.buf = self.buf[:, ws:]
        return b"".join(out)

    def finish(self):
        """Encode the remaining samples (decomposed like the one-shot
        remainder) and close the stream on the CBR grid."""
        if not self.buf.shape[1]:
            with scope("NativeAssembler.finish"):
                return self.asm.finish()
        total = -(-self.buf.shape[1] // self.spf) * self.spf
        pcm_r = np.pad(self.buf, ((0, 0), (0, total - self.buf.shape[1])))
        self.buf = np.zeros((self.nch, 0), np.int16)
        plan = _plan_segments(total // 576, self.rem_buckets)
        return b"".join(
            self._encode_window(pcm_r[:, pos * 576:(pos + n_real) * 576],
                                i == len(plan) - 1)
            for i, (pos, n_real, _) in enumerate(plan))

    def checkpoint(self):
        """A small dict of numpy and Python values; ``resume`` continues
        the stream from it with byte-identical output.  Reading the
        device's carry waits for the stream's queued work."""
        return dict(fsm=self.fsm.cpu().numpy(), halo4=self.halo4.copy(),
                    scan_size=int(self.scan_size),
                    real_size=int(self.real_size), buf=self.buf.copy(),
                    asm=self.asm.checkpoint())

    @classmethod
    def resume(cls, cfg, ckpt, device, window=None):
        enc = cls(cfg, device, window=window)
        enc.fsm = torch.as_tensor(np.asarray(ckpt["fsm"]), dtype=torch.int32,
                                  device=enc.L3.dev)
        enc.halo4 = np.asarray(ckpt["halo4"], np.int16).copy()
        enc.scan_size = int(ckpt["scan_size"])
        enc.real_size = int(ckpt["real_size"])
        enc.buf = np.asarray(ckpt["buf"], np.int16).copy()
        enc.asm.restore(ckpt["asm"])
        return enc

    def _encode_window(self, pcm_w, is_last):
        L3, nch = self.L3, self.nch
        G = pcm_w.shape[1] // 576
        n_pad = (G if G == self.window
                 else _plan_segments(G, self.rem_buckets)[0][2])
        blocks = pcm_w.reshape(nch, G, 576)
        with scope("upload"):
            host = pinned((nch, 4 + n_pad, 576), torch.int16, L3.dev)
            bl = host.numpy()
            bl[:, :4] = self.halo4
            bl[:, 4:4 + G] = blocks
        # the same segment program as the one-shot path, so stream and
        # one-shot bytes agree by construction; the window's one wait
        h = L3.segment(host, self.fsm, self.scan_size, PAYLOAD_WORDS, G,
                       RELAX_DELTA)
        got, = L3.fetch([h])
        self.fsm, self.scan_size = h["fsm_state"], h["size"]
        self.halo4 = blocks[:, -4:] if G >= 4 else np.concatenate(
            [self.halo4[:, G - 4:], blocks], axis=1)
        plan = [(0, G, n_pad)]
        nframes = G // L3.mode_gr
        side, payload, _, _, self.real_size = L3.settle(
            plan, [h], [got], PAYLOAD_WORDS, nframes, size=self.real_size)
        L3.weave(self.asm, nframes, side, payload,
                 L3.scfsi_frames(plan, [got]))
        with scope("NativeAssembler.finish"):
            return self.asm.finish() if is_last else self.asm.drain()


def encode_layer3_stream(pcm_iter, cfg: EncoderConfig, device, window=None):
    """Generator form of StreamEncoder: consume an iterator of PCM
    pieces, yield MP3 byte chunks as frames complete."""
    enc = StreamEncoder(cfg, device, window=window)
    for piece in pcm_iter:
        chunk = enc.feed(piece)
        if chunk:
            yield chunk
    tail = enc.finish()
    if tail:
        yield tail


# ---------------------------------------------------------------------------
# Layers I/II
# ---------------------------------------------------------------------------

def _frame_bytes(cfg):
    """(samples per frame, bits per slot, whole slots per frame)."""
    spf = 384 if cfg.layer == 1 else 1152
    bits_per_slot = 32 if cfg.layer == 1 else 8
    sfreq_khz = mpeg.S_FREQ_KHZ[cfg.version][cfg.sampling_frequency]
    whole_spf = int((spf / float(sfreq_khz))
                    * (cfg.bitrate_kbps / float(bits_per_slot)))
    return spf, bits_per_slot, whole_spf


class _Layer12Plan:
    """The constants of a Layer I/II encode of F frames under `cfg`."""

    def __init__(self, cfg, F):
        self.layer, self.nch, self.F = cfg.layer, cfg.nchannels, F
        self.spf, bits_per_slot, whole_spf = _frame_bytes(cfg)
        self.adb = whole_spf * bits_per_slot            # a frame's bits
        self.frame_bytes = self.adb // 8
        self.joint = cfg.mode == mpeg.MODE_JOINT
        sfreq_khz = mpeg.S_FREQ_KHZ[cfg.version][cfg.sampling_frequency]
        self.sfreq_hz = float(sfreq_khz) * 1000.0
        self.table, self.sblimit = T12.pick_table(
            cfg.version, cfg.layer, cfg.bitrate_index,
            cfg.sampling_frequency, self.nch, cfg.bitrate_kbps,
            float(sfreq_khz))


@span("_layer12_frame")
def _layer12_frame(pcm, cfg, dev=None):
    """(plan, PCM as (nch, F * spf) padded to whole frames): a numpy view
    of the host tensor that ``_layer12_upload`` uploads, pinned for a
    CUDA `dev` (the view keeps the tensor alive).  The clip crosses host
    memory once, from the caller's array into the buffer (for (samples,
    channels) input a transposing copy), and only the tail past its last
    sample is zeroed.  int16 PCM stays int16; any other dtype becomes
    float32 in that same copy (counted in ``float_frames_l12``), as the
    JAX package frames it (a float PCM is never cast to int16)."""
    global float_frames_l12
    cfg.finalize()
    if cfg.layer not in (1, 2):
        raise ValueError("Layer I/II encodes take layer 1 or 2")
    pcm = np.atleast_2d(np.asarray(pcm))
    if pcm.shape[0] > pcm.shape[1]:
        pcm = pcm.T
    if pcm.shape[0] != cfg.nchannels:
        raise ValueError(f"pcm has {pcm.shape[0]} channels, config "
                         f"{cfg.nchannels}")
    n = pcm.shape[1]
    spf = _frame_bytes(cfg)[0]
    P = _Layer12Plan(cfg, -(-n // spf))
    dtype = torch.int16
    if pcm.dtype != np.int16:
        dtype = torch.float32
        with _FLOAT_FRAMES_LOCK:
            float_frames_l12 += 1
    host = torch.empty((P.nch, P.F * spf), dtype=dtype,
                       pin_memory=dev is not None and dev.type == "cuda")
    framed = host.numpy()
    framed[:, :n] = pcm
    framed[:, n:] = 0
    return P, framed


@span("upload")
def _to_device(arr, dtype, dev):
    """A numpy array on `dev` through a pinned buffer (not zeroed: the
    array fills it): its upload is queued and the host does not wait."""
    host = torch.empty(arr.shape, dtype=dtype, pin_memory=dev.type == "cuda")
    host.numpy()[...] = arr
    return upload(host, dev)


@span("upload")
def _layer12_upload(pcm, dev):
    """The framed PCM on `dev` in its own dtype (int16: half the bytes of
    float32), uploaded from the array itself: from ``_layer12_frame``'s
    pinned buffer the copy is queued and the host does not wait."""
    return upload(torch.from_numpy(pcm), dev)


def _layer12_analysis(pcm, P, dev):
    """The framed PCM uploaded once and ``ops/layer12.analyze_frames`` on
    `dev`."""
    return L12.analyze_frames(_layer12_upload(pcm, dev), P.layer, P.sblimit,
                              P.nch, P.sfreq_hz)


@span("_layer12_quantize")
def _layer12_quantize(ana, P, jsbound, ba):
    """The quantizers of every frame on the analysis' device: codes (nch,
    F, G, 12, 32) of the subband samples at bit allocation `ba` (F, 2, 32);
    above `jsbound` (F,) channel 0's lane carries the joint samples and
    scales (encode.c:1245-1249, 1288-1291)."""
    sb, sc = ana["sb"], ana["scalar"]
    sb0, sc0 = sb[0], sc[0]
    if P.joint and P.nch == 2:
        js = torch.arange(32, device=sb.device)[None, :] >= \
            jsbound.to(torch.int64)[:, None]                # (F, 32)
        sb0 = torch.where(js[:, None, None, :], ana["j_sample"], sb0)
        sc0 = torch.where(js[:, None, :], ana["j_scale"], sc0)

    def quant(s, c, b):
        return (L12.quantize_l1(s, c, b) if P.layer == 1
                else L12.quantize_l2(s, c, b, P.table))

    return torch.stack([quant(sb0, sc0, ba[:, 0])] + (
        [quant(sb[1], sc[1], ba[:, 1])] if P.nch == 2 else []))


def _layer12_k5_inputs(ana, P, snr):
    """K5's inputs from the analysis outputs: the SMR (F, 2, 32) float64
    of `snr` (nch, F, 32) and, for Layer II, the scfsi (F, 2, 32) int32;
    for mono channel 1 is a copy of channel 0."""
    nch = P.nch
    smr = torch.stack([snr[0], snr[nch - 1]], dim=1).to(torch.float64)
    if P.layer == 1:
        return smr.contiguous(), None
    scfsi = ana["scfsi"]
    return smr.contiguous(), torch.stack([scfsi[0], scfsi[nch - 1]],
                                         dim=1).to(torch.int32)


def _layer12_elements(ana, cfg, P, alloc):
    """The quantizers at K5's allocation `alloc` and ``marshal_frames``:
    K6's (values, lengths, CRC range)."""
    jsbound = alloc["jsbound"]
    codes = _layer12_quantize(ana, P, jsbound, alloc["ba"])
    return L12.marshal_frames(
        cfg, P.layer, P.table, P.sblimit, P.nch, alloc["mode"],
        alloc["mode_ext"], jsbound, alloc["ba"], ana.get("scfsi"),
        ana["scalar"], codes, alloc["adb_left"], P.adb)


def _back_ops(ana, cfg, P, pcm=None):
    """The back half op by op on the analysis' device: the SMR in
    float64, K5 (the joint decision and the greedy allocation), the
    quantizers with the joint samples above jsbound, ``marshal_frames``
    and K6.  Returns K6's buffer (``ops/pack12.split``), still on the
    device; on a CPU tensor the plain versions run.  With psy model 1 the
    SMR is computed on the host from the downloaded subband samples of
    `pcm`'s analysis (``numpy_ref.tonal.psycho_one_frames``) and
    uploaded: one more wait."""
    with scope("_layer12_back.smr"):
        snr = ana["snr"]
        if cfg.psy_model == 1:
            from .numpy_ref.tonal import psycho_one_frames
            snr = _to_device(psycho_one_frames(
                pcm.astype(np.float64), P.layer, cfg,
                ana["sb"].cpu().numpy()), torch.float64, ana["sb"].device)
        smr, scfsi = _layer12_k5_inputs(ana, P, snr)
    alloc = A12.allocate(smr, scfsi, P.layer, P.table, P.nch, P.sblimit,
                         P.adb, cfg.error_protection, P.joint, cfg.mode)
    values, lengths, crc = _layer12_elements(ana, cfg, P, alloc)
    return P12.pack_frames(values, lengths, P.frame_bytes, crc)


#: ``_back_ops`` in the span _layer12_back: the back half of the
#: op-by-op route
_layer12_back = span("_layer12_back")(_back_ops)


#: the configuration's values that the back half bakes into its graph
#: besides the plan's (``_back_key``): the header's fields, the CRC's
#: switch and the mode
BACK_FIELDS = ("version", "bitrate_index", "sampling_frequency",
               "extension", "copyright", "original", "emphasis",
               "error_protection", "mode")


def _back_key(cfg, P):
    """Every Python value that the back half bakes into a captured graph:
    ``BACK_FIELDS`` of `cfg` and the plan's layer, nch, joint, adb,
    frame_bytes, table and sblimit, so that two configurations that differ
    in any of them never share a graph."""
    return (tuple((k, getattr(cfg, k)) for k in BACK_FIELDS),
            tuple((k, getattr(P, k)) for k in (
                "layer", "nch", "joint", "adb", "frame_bytes", "table",
                "sblimit")))


def _layer12_eager(pcm, cfg, P, dev):
    """The op-by-op route: the upload, ``analyze_frames`` (one graph a
    key on the card, its outputs cloned) and ``_layer12_back``; K6's
    buffer on `dev`."""
    return _layer12_back(_layer12_analysis(pcm, P, dev), cfg, P, pcm)


def _layer12_replayed(pcm, cfg, P, dev):
    """The replayed route on a CUDA device with psy model 2: the upload,
    then the analysis and the back half as two CUDA graphs of one key
    (``ops/layer12.encode_frames``, the back half's replay and the copy
    of K6's buffer in the span _layer12_back); K6's buffer on `dev`."""
    return L12.encode_frames(_layer12_upload(pcm, dev), P.layer, P.sblimit,
                             P.nch, P.sfreq_hz,
                             lambda ana: _back_ops(ana, cfg, P),
                             _back_key(cfg, P))


@span("_fetch_frames")
def _fetch_frames(buf):
    """The host's one wait of a Layer I/II encode: K6's buffer downloaded
    (``queue_download``, ``Download.wait``); raises if its status words
    report a malformed frame.  Returns the frames' bytes."""
    host, done = queue_download(buf)
    got, = Download([[("buf", tuple(buf.shape))]], host, done).wait()
    status, frames = P12.split(torch.from_numpy(got["buf"]))
    P12.check_status(status)
    return frames.numpy().tobytes()


def encode_layer12_fast(pcm, cfg: EncoderConfig, device):
    """Layer I/II encode of int16 PCM on `device`, as one chain queued on
    the device: the PCM copied once into a pinned buffer and uploaded
    from it (int16 PCM as int16, any other as float32), the analysis
    (filterbank, psy model 2, scale factors, scfsi: ``ops/layer12.py``),
    K5 (the joint decision and the greedy bit allocation,
    ``ops/alloc12.py``), the quantizers, the element marshalling
    (``marshal_frames``) and K6 (every frame packed into its fixed byte
    range with its CRC, ``ops/pack12.py``); then the bytes and K6's
    status come back in one download.  On a CUDA device with psy
    model 2 the chain replays two CUDA graphs of one key, the analysis and
    the back half (``_layer12_replayed``), and the host waits once an
    encode; with psy model 1, which runs on the host (the subband samples
    come back for it and its SMR goes up), the analysis replays its graph
    and the back half runs op by op (``_layer12_eager``), and the host
    waits twice.  On the CPU the op-by-op route runs the kernels' plain
    versions.  A frame that K6 finds malformed raises after the wait.
    The stream ends in one flush byte, as the JAX package's.

    Float32 DSP and an FFT library's rounding instead of the reference's
    float32 split-radix can move allocation ties; streams stay valid and
    decoded quality equal."""
    dev = resolve_device(device)
    P, pcm = _layer12_frame(pcm, cfg, dev)
    route = (_layer12_replayed if dev.type == "cuda" and cfg.psy_model == 2
             else _layer12_eager)
    return _fetch_frames(route(pcm, cfg, P, dev)) + b"\x00"


def encode_layer12_stream(pcm_iter, cfg: EncoderConfig, device,
                          window_frames=512):
    """O(window) streaming Layer I/II encode: consume an iterator of
    (n,), (n, nch) or (nch, n) int16 PCM pieces, yield MP3 byte chunks.

    Layer I/II frames are bitstream-independent (no back-pointer), so
    windows of W frames encoded with a 4-frame halo of true history
    concatenate into the one-shot stream: every cross-frame lookback --
    the 512-tap filterbank, the psy window starts and the
    unpredictability's two-window history -- reaches at most 4 frames
    back, and CBR frames are fixed-size, so the halo frames' bytes cut
    exactly."""
    cfg.finalize()
    if cfg.layer not in (1, 2):
        raise ValueError("encode_layer12_stream encodes Layers I/II only")
    resolve_device(device)
    nch = cfg.nchannels
    spf, bits_per_slot, whole_spf = _frame_bytes(cfg)
    frame_bytes = whole_spf * (bits_per_slot // 8)
    halo_f = 4

    buf = np.zeros((nch, 0), np.int16)
    halo = np.zeros((nch, 0), np.int16)    # grows to halo_f frames
    ws = window_frames * spf

    def step(pcm_w):
        """Encode [halo | window]; the window frames' bytes."""
        nonlocal halo
        ext = np.concatenate([halo, pcm_w], axis=1)
        out = encode_layer12_fast(ext.T, cfg, device)
        cut = (halo.shape[1] // spf) * frame_bytes
        keep = min(halo_f * spf, ext.shape[1])
        halo = ext[:, -keep:]
        return out[cut:-1]                 # drop halo frames + flush byte

    for piece in pcm_iter:
        piece = np.atleast_2d(np.asarray(piece, np.int16))
        if piece.shape[0] != nch:          # never flip a final (nch, 1) piece
            piece = piece.T
        if piece.shape[0] != nch:
            raise ValueError(f"piece of shape {piece.shape} for {nch} "
                             "channels")
        buf = np.concatenate([buf, piece], axis=1)
        while buf.shape[1] >= ws:
            yield step(buf[:, :ws])
            buf = buf[:, ws:]
    if buf.shape[1]:
        nf = -(-buf.shape[1] // spf)
        yield step(np.pad(buf, ((0, 0), (0, nf * spf - buf.shape[1]))))
    yield b"\x00"                          # the one-shot flush byte

