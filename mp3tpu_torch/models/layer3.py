"""Layer III segment encoder (port of mp3tpu/models/layer3.py).

``Layer3SegmentEncoder`` is the segment program for one
(version, sampling_frequency): analysis + demand encode -> reservoir
scan -> final encode + on-device emission and packing.  Its constant
matrices and lookup tables are buffers, built from the port's ``tables`` or
loaded from the JAX package's own numpy constants; equal tables on one
device are one set of tensors, shared by every encoder, and an encoder
of a (version, sampling_frequency, device) made before gives the next
its tensors without making or hashing them again (``rate_tables``).

On a CUDA device the program (``forward``, alias
``encode_segment_fused``) replays one CUDA graph a call, the port's
counterpart of the JAX package's one compiled program
(``ops/graphs.py``): ``_segment`` chains the analysis of all lanes in one
batch, the demand rate loop, the reservoir scan (one K4 launch,
``ops/resv.py``), the final budgets, the final rate loop and the
emission and packing, captured once per key (``SEGMENTS``: the inputs'
layout, the segment's constants and the tables' identity; stage
"segment").  The clip length ``n_real`` is one of the graph's inputs, as
the JAX package traces it, so one graph serves every clip length of a
segment width.  So a segment queues all its work without a wait on the
host, and the encode functions fetch the results of every queued
segment in one download (``encoder._Layer3Framing.fetch``).

``encode_segment_staged`` is the same program in stages, each captured
on its own: the analysis (``analysis``), the rate loop
(``loop.outer_loop``) and, after the final rate loop, the emission and
packing (``encode_final``), with the scan and the final budgets
dispatched op by op between them.  It is what the CPU runs, and on the
card the yardstick of the one graph; ``analysis_eager`` (lane by lane)
and ``encode_final_eager`` (emission op by op) are in turn the
yardsticks of its captured stages.

Quality deviations from the reference are those of the JAX package:
true quantization range, psy outputs used for the granule they were
computed on, and scfsi with the intended per-channel indexing.
"""
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..tables import mpeg

from ..ops import bits, dsp, graphs, lanes, loop, psy, resv, search
from ..runtime.profiling import span

#: sfb -> scfsi band map (loop.c scfsi_band_long 0,6,11,16,21)
BAND_OF_SFB = np.repeat(np.arange(4), np.diff(mpeg.SCFSI_BAND_LONG))
#: the process's captured analyses of the staged form
#: (``graphs.GraphCache``; a stereo clip of one sample rate makes 2 keys,
#: a corpus group 1 a segment width)
GRAPHS = graphs.GraphCache(16)
#: the process's captured segment programs (``graphs.GraphCache``; the
#: bench clip's plan, 512- and 4096-lane segments, makes 2 keys)
SEGMENTS = graphs.GraphCache(16)
#: the rate loop's iterations at most, as ``loop.outer_loop``'s default
MAX_ITER = 6


def device_tables(device):
    """The segment program's own tables on `device`: the scfsi band of
    each long sfb, one-hot (21, 4) float32 and as indices (21,) int64
    (``graphs.shared_tensors``)."""
    return graphs.shared_tensors(dict(
        scfsi_band_oh=(np.arange(4)[None, :] == BAND_OF_SFB[:, None])
        .astype(np.float32), band_of_sfb=BAND_OF_SFB.astype(np.int64)),
        device)


def _groups(d, device):
    """The segment program's tables on `device` by group ("st", "psy",
    "dsp", "bits", "l3") from numpy constants in the JAX package's form
    (``Layer3SegmentEncoder.load_numpy_constants``' `d`)."""
    return dict(st=loop.device_tables(d["static"], device),
                psy=psy.device_tables(d, device),
                dsp=dsp.device_tables(d["dsp"], device),
                bits=bits.device_tables(device), l3=device_tables(device))


@lru_cache(maxsize=None)
def rate_tables(version, sampling_frequency, device):
    """The tables by group of one (version, sampling_frequency) on
    `device` (a ``graphs.canonical_device``), made once: each later
    encoder of the key registers these tensors, with no table made or
    hashed (``graphs.fingerprint``) again.  They are the tensors that
    ``graphs.shared_tensors`` gives, so the graphs' keys are
    unchanged."""
    sfreq_hz = float(mpeg.S_FREQ_KHZ[version][sampling_frequency]) * 1000.0
    return _groups(dict(static=loop.static_tables(version,
                                                  sampling_frequency),
                        dsp=dsp.numpy_constants(),
                        **psy.numpy_constants(sfreq_hz)), device)


def _scfsi_flags(xr, ratio_l, ratio_s, block_type, ST, LT):
    """scfsi decision for each lane's granule batch (loop.c:615-720, with
    the intended per-channel indexing).  xr (L, C, 576): granule pairs
    are (2f, 2f+1).  Returns (L, C//2, 4) int32 flags; one lane may come
    without its lane axis.  LT: the segment program's ``device_tables``."""
    if xr.dim() == 2:
        return _scfsi_flags(xr[None], ratio_l[None], ratio_s[None],
                            block_type[None], ST, LT)[0]
    xr_abs = xr.abs()
    en_sfb = lanes.mm(xr_abs * xr_abs, ST["oh_l"], "scfsi_energy")
    # the allowed distortion of loop.calc_xmin (long bands)
    xmin_l = ratio_l * (en_sfb / ST["bw_l"])                # (L, C, 21)
    ln2 = float(np.log(2.0))
    en = torch.where(en_sfb > 0,
                     torch.trunc(torch.log(torch.clamp(en_sfb, min=1e-37))
                                 / ln2), 0.0)
    xm = torch.where(xmin_l > 0,
                     torch.trunc(torch.log(torch.clamp(xmin_l, min=1e-37))
                                 / ln2), 0.0)
    # reference scale: xr in int16 units; int(max|xr|) != 0
    nonsilent = xr_abs.amax(dim=-1) * 32768.0 >= 1.0
    long_ok = block_type != 2
    en0, en1 = en[:, 0::2], en[:, 1::2]
    xm0, xm1 = xm[:, 0::2], xm[:, 1::2]
    cond = (nonsilent[:, 0::2] & nonsilent[:, 1::2] & long_ok[:, 0::2]
            & long_ok[:, 1::2] & ((en0 - en1).abs().sum(dim=-1) < 100.0))
    den = lanes.mm((en0 - en1).abs(), LT["scfsi_band_oh"], "scfsi_bands")
    dxm = lanes.mm((xm0 - xm1).abs(), LT["scfsi_band_oh"], "scfsi_bands")
    return (cond[..., None] & (den < 10.0) & (dxm < 10.0)).to(torch.int32)


def _finite_guard(ana):
    """NaN/Inf guard: a granule whose analysis went non-finite is
    degraded to silence instead of poisoning the rate loop.  Returns the
    guarded xr, pe, ratio_l, ratio_s and n_nonfinite ()."""
    finite = (torch.isfinite(ana["xr"]).all(dim=1)
              & torch.isfinite(ana["pe"])
              & torch.isfinite(ana["ratio_l"]).all(dim=1)
              & torch.isfinite(ana["ratio_s"]).flatten(1).all(dim=1))
    return dict(xr=torch.where(finite[:, None], ana["xr"], 0.0),
                pe=torch.where(finite, ana["pe"], 0.0),
                ratio_l=torch.where(finite[:, None], ana["ratio_l"], 0.0),
                ratio_s=torch.where(finite[:, None, None], ana["ratio_s"],
                                    0.0),
                n_nonfinite=(~finite).sum().to(torch.int32))


def final_budgets(demand, budgets, n_real, nch, mode_gr):
    """The final encode's budgets from the scan's granule-major budgets
    (F, R): target = min(demand, budget) (nch, n_pad); the budget row
    (nch*n_pad,) float32 is the target where it is below the demand and
    the granule is real (before n_real), else 4095."""
    target = torch.minimum(demand,
                           resv.from_granule_major(budgets, nch, mode_gr))
    valid = torch.arange(demand.shape[1], device=demand.device)[None, :] \
        < n_real
    row = torch.where(valid & (target < demand), target.to(torch.float32),
                      4095.0).reshape(-1)
    return target, row


@span("pack_state")
def pack_state(state, block_type):
    """The (N, 19) int16 side-info table in exactly the layout the native
    assembler reads (csrc/mp3bits.cpp GranuleSide)."""
    bt = block_type.to(torch.int32)
    wsf = (bt != mpeg.NORM_TYPE).to(torch.int32)
    z = torch.zeros_like(wsf)
    ts = state["table_select"].to(torch.int32)
    i32 = lambda k: state[k].to(torch.int32)  # noqa: E731
    cols = [i32("part2_3_length"), i32("big_values"), i32("global_gain"),
            i32("compress"), wsf, torch.where(wsf == 1, bt, 0),
            z,                                              # mixed
            ts[:, 0], ts[:, 1], ts[:, 2], i32("r0"), i32("r1"),
            i32("preflag"),
            z,                                              # subblock/pad
            i32("count1table_select"), i32("part2"), i32("a1"), i32("a2"),
            i32("count1")]
    return torch.stack(cols, dim=1).to(torch.int16)


class Layer3SegmentEncoder(nn.Module):
    """The Layer III segment program for one (version, sampling_frequency)
    on `device`: MPEG-1 (32/44.1/48 kHz) or MPEG-2 LSF (16/22.05/24 kHz,
    one granule per frame, no scfsi)."""

    def __init__(self, version, sampling_frequency, device):
        super().__init__()
        self.version = version
        self.sampling_frequency = sampling_frequency
        self.sfreq_hz = float(mpeg.S_FREQ_KHZ[version][sampling_frequency]) \
            * 1000.0
        self._groups = {}
        for group, tables in rate_tables(
                version, sampling_frequency,
                graphs.canonical_device(device)).items():
            self._register(group, tables)

    def _register(self, group, tables):
        """Tensors become buffers `<group>_<name>`, Python values plain
        attributes; ``tables(group)`` reassembles the dict."""
        for k, v in tables.items():
            if isinstance(v, torch.Tensor):
                self.register_buffer(f"{group}_{k}", v, persistent=False)
            else:
                setattr(self, f"{group}_{k}", v)
        self._groups[group] = list(tables)

    def tables(self, group):
        """The `group` ("st", "psy", "dsp", "bits" or "l3") tables as a
        dict."""
        return {k: getattr(self, f"{group}_{k}") for k in self._groups[group]}

    def load_numpy_constants(self, d, device=None):
        """Make the buffers from numpy constants in the JAX package's form:
        d["static"] (jaxloop._static), d["psy_mats"] (jaxpsy._psy_mats),
        d["dft"] {n: jaxpsy._dft_mats(n)}, d["hann"] {n: jaxpsy._hann(n)},
        d["dsp"] {"enwindow_rev", "ana_filter_rev", "basis_long",
        "basis_short", "alias"} (jaxdsp._ENWINDOW_REV, ...)."""
        if device is None:
            device = self.st_oh_l.device
        for group, tables in _groups(d, device).items():
            self._register(group, tables)
        return self

    # ------------------------------------------------------------------
    def _analyze_chunk(self, blocks_ext, halo2, fsm_init):
        """One channel's chunk: blocks_ext (2 warmup + C, 576), halo2
        (2, 576) before the warmups."""
        p = psy.psycho_granules(blocks_ext, halo2, self.tables("psy"),
                                warmup=2, fsm_init=fsm_init)
        return dict(xr=self.spectrum(blocks_ext, p["block_type"]),
                    pe=p["pe"], ratio_l=p["ratio_l"],
                    ratio_s=p["ratio_s"], block_type=p["block_type"],
                    fsm_state=p["fsm_state"])

    def spectrum(self, blocks_ext, block_type):
        """Filterbank + MDCT of each lane's chunk (L, 2 warmup + C, 576)
        at its block types (L, C): xr (L, C, 576).  One lane may come
        without its lane axis."""
        if blocks_ext.dim() == 2:
            return self.spectrum(blocks_ext[None], block_type[None])[0]
        DT = self.tables("dsp")
        scaled = blocks_ext / 32768.0
        sb = dsp.subband_granules(scaled[:, 2:], scaled[:, 1, 64:], DT)
        sb_prev = dsp.subband_granules(scaled[:, 1:2], scaled[:, 0, 64:],
                                       DT)[:, 0]
        return dsp.mdct_granules(sb, sb_prev, block_type, DT)

    def _analysis(self, blocks_h4, fsm_init):
        """The analysis of a segment's lanes in one batch: psy, filterbank,
        MDCT, the NaN/Inf guard and (MPEG-1) the scfsi flags.  It builds
        no tensor from host data and reads none back, so that a CUDA
        graph can capture it (``analysis``); its outputs equal
        ``analysis_eager``'s."""
        ST, LT = self.tables("st"), self.tables("l3")
        L, S = blocks_h4.shape[0], blocks_h4.shape[1] - 4
        blocks = blocks_h4.to(torch.float32)
        p = psy.psycho_granules(blocks[:, 2:], blocks[:, :2],
                                self.tables("psy"), warmup=2,
                                fsm_init=fsm_init)
        xr = self.spectrum(blocks[:, 2:], p["block_type"])  # (L, S, 576)
        res = _finite_guard(dict(
            xr=xr.reshape(L * S, 576), pe=p["pe"].reshape(-1),
            ratio_l=p["ratio_l"].reshape(L * S, 21),
            ratio_s=p["ratio_s"].reshape(L * S, 12, 3)))
        res.update(block_type=p["block_type"].reshape(-1),
                   fsm_state=p["fsm_state"])
        if not ST["lsf"]:
            # from the spectrum before the guard, as the per-lane form
            res["scfsi"] = _scfsi_flags(xr, p["ratio_l"], p["ratio_s"],
                                        p["block_type"], ST, LT)
        return res

    def analysis_eager(self, blocks_h4, fsm_init):
        """``_analysis`` lane by lane, op by op: what the CPU runs, and on
        the card the yardstick of the captured analysis."""
        ST, LT = self.tables("st"), self.tables("l3")
        nch = blocks_h4.shape[0]
        blocks = blocks_h4.to(torch.float32)
        anas = [self._analyze_chunk(blocks[ch, 2:], blocks[ch, :2],
                                    fsm_init[ch]) for ch in range(nch)]
        fsm_state = torch.stack([a.pop("fsm_state") for a in anas])
        res = _finite_guard({k: torch.cat([a[k] for a in anas])
                             for k in ("xr", "pe", "ratio_l", "ratio_s")})
        res.update(block_type=torch.cat([a["block_type"] for a in anas]),
                   fsm_state=fsm_state)
        if not ST["lsf"]:
            res["scfsi"] = torch.stack([
                _scfsi_flags(a["xr"], a["ratio_l"], a["ratio_s"],
                             a["block_type"], ST, LT) for a in anas])
        return res

    def analysis(self, blocks_h4, fsm_init):
        """The analysis of a segment: blocks_h4 (nch, 4+S, 576)
        int16-valued (rows 0:2 psy halo, rows 2:4 warmup granules),
        fsm_init (nch,) int32.  Returns xr (nch*S, 576), pe, ratio_l,
        ratio_s, block_type (rows lane-major), fsm_state (nch,),
        n_nonfinite () and for MPEG-1 scfsi (nch, S//2, 4).

        On a CUDA tensor ``_analysis`` replays a CUDA graph captured on
        its key's first call (``GRAPHS``: the inputs' layout and the
        tables' identity; stage "analysis"), and the caller gets clones
        of its static outputs; a capture or replay error raises.  On any
        other device it is ``analysis_eager``."""
        if blocks_h4.device.type != "cuda":
            return self.analysis_eager(blocks_h4, fsm_init)
        dev = blocks_h4.device
        inputs = dict(blocks_h4=blocks_h4, fsm_init=fsm_init)
        return graphs.on_stream(
            dev, lambda: self._run_analysis(inputs, graphs.cuda_graph(dev)),
            lambda entry: {k: v.clone()
                           for k, v in entry.outputs["analysis"].items()})

    def _run_analysis(self, inputs, record):
        """``analysis``'s host side (``graphs.run`` of ``_analysis``) on the
        current stream: (entry, the entries the cache dropped)."""
        tables = tuple(self.tables(g) for g in ("st", "psy", "dsp", "l3"))
        return graphs.run(
            GRAPHS, graphs.key_of(inputs, *tables), "analysis", inputs,
            lambda i: self._analysis(i["blocks_h4"], i["fsm_init"]), record,
            refs=tables)

    @span("analyze_demand_fused")
    def analyze_demand_fused(self, blocks_h4, fsm_init):
        """Analysis + unconstrained (4095-bit) demand encode of a segment.

        blocks_h4 (nch, 4+S, 576) int16-valued; rows 0:2 psy halo, rows
        2:4 warmup granules.  fsm_init (nch,) int32.  Returns xr (nch*S,
        576) and its rate-loop inputs, pe, p23 (demand), qss (warm lower
        bound for the final encode), fsm_state, n_nonfinite, and for
        MPEG-1 the scfsi flags with the demand granule-0 scalefactors."""
        ana = self.analysis(blocks_h4, fsm_init)
        out = loop.outer_loop(ST=self.tables("st"), **_demand_args(ana))
        return self._demand_outputs(ana, out, blocks_h4.shape[0])

    def _demand_outputs(self, ana, out, nch):
        """``analyze_demand_fused``'s outputs from the analysis `ana` and
        the demand rate loop's outputs `out`."""
        res = dict(
            xr=ana["xr"], ratio_l=ana["ratio_l"], ratio_s=ana["ratio_s"],
            block_type=ana["block_type"], pe=ana["pe"],
            p23=out["part2_3_length"].to(torch.int32),
            qss=out["qss0"].to(torch.float32), fsm_state=ana["fsm_state"],
            n_nonfinite=ana["n_nonfinite"])
        if not self.tables("st")["lsf"]:
            S = ana["xr"].shape[0] // nch
            res["scfsi"] = ana["scfsi"]
            res["sf_fix"] = out["sf_l"].reshape(nch, S, 21)[:, 0::2] \
                .to(torch.int8)
        return res

    def _final_args(self, xr, ratio_l, ratio_s, block_type, budget, scfsi,
                    sf_fix, nch, qss_lo):
        """The final encode's rate-loop arguments by name (``loop._inputs``):
        scfsi (nch, C//2, 4) + sf_fix (nch, C//2, 21) become the fixed
        and skipped bands' masks (MPEG-1 only)."""
        is_short_block = block_type != mpeg.NORM_TYPE
        mask = vals = skipm = None
        if scfsi is not None and sf_fix is not None and \
                not self.tables("st")["lsf"]:
            N = xr.shape[0]
            C = N // nch
            band_idx = self.tables("l3")["band_of_sfb"]
            band = scfsi.reshape(nch, C // 2, 4).bool()[:, :, band_idx]
            mask = band.repeat_interleave(2, dim=1).reshape(N, 21)
            vals = sf_fix.reshape(nch, C // 2, 21) \
                .repeat_interleave(2, dim=1).reshape(N, 21)
            odd = (torch.arange(C, device=xr.device) % 2) == 1
            skipm = mask & odd.repeat(nch)[:, None]
        return loop._inputs(xr, budget, ratio_l, ratio_s, is_short_block,
                            block_type, mask, vals, skipm, qss_lo)

    def _emission(self, out, inputs, payload_words, flat_cap):
        """Emit and pack the final rate loop's outputs `out` (its inputs
        by name): the signed spectrum, ``granule_payload``, with flat_cap
        ``compact_payload``, and ``pack_state``.  Returns dict(side,
        payload).  Capture-safe: the continuation of the rate loop's
        graphs on the card (``encode_final``)."""
        ST = self.tables("st")
        xr, block_type = inputs["xr"], inputs["block_type"]
        is_short = inputs["is_short_block"] & (block_type == 2)
        ix_signed = torch.where((xr < 0) & (out["ix"] > 0), -out["ix"],
                                out["ix"])
        payload, nbits = bits.granule_payload(
            out, ix_signed, is_short, ST, self.tables("bits"),
            payload_words, skip_mask=inputs["sf_skip_mask"])
        if flat_cap is not None:
            payload = bits.compact_payload(payload, nbits, flat_cap)
        return dict(side=pack_state(out, block_type), payload=payload)

    @span("encode_final")
    def encode_final(self, xr, ratio_l, ratio_s, block_type, budget,
                     payload_words=bits.PAYLOAD_WORDS, scfsi=None,
                     sf_fix=None, nch=1, qss_lo=None, flat_cap=None):
        """Encode at the final budgets and emit + pack the main data.

        scfsi (nch, C//2, 4) + sf_fix (nch, C//2, 21): granule pairs
        whose marked bands are sent once; both granules of a pair fix
        those bands to the demand values, granule 1 skips sending them.
        MPEG-2 LSF has no scfsi: both are ignored there.  Returns
        dict(side (N, 19) int16, payload: (N, payload_words) rows or, with
        flat_cap, the compacted (flat_cap,) buffer).

        On a CUDA tensor the emission and packing (``_emission``) run as
        the rate loop's continuation (``loop.Then``): one graph a key
        (the loop's, payload_words, flat_cap, the emission tables'
        identity; stage "emission") replayed after the loop's last
        iteration, inside the span granule_payload.  On any other device
        it is ``encode_final_eager``."""
        if xr.device.type != "cuda":
            return self._final_eager(
                xr, ratio_l, ratio_s, block_type, budget, payload_words,
                scfsi, sf_fix, nch, qss_lo, flat_cap)
        return loop.outer_loop(ST=self.tables("st"),
                               then=self._then(payload_words, flat_cap),
                               **self._final_args(
                                   xr, ratio_l, ratio_s, block_type, budget,
                                   scfsi, sf_fix, nch, qss_lo))

    def _then(self, payload_words, flat_cap):
        """``_emission`` as the final rate loop's continuation: its key
        (payload_words, flat_cap, the emission tables' identity) beside
        the loop's own (lanes, masks, the rate's tables)."""
        BT = self.tables("bits")
        return loop.Then(
            key=(payload_words, flat_cap,
                 tuple((k, id(v)) for k, v in BT.items())),
            fn=lambda out, inputs: self._emission(out, inputs,
                                                  payload_words, flat_cap),
            span="granule_payload")

    @span("encode_final")
    def encode_final_eager(self, xr, ratio_l, ratio_s, block_type, budget,
                           payload_words=bits.PAYLOAD_WORDS, scfsi=None,
                           sf_fix=None, nch=1, qss_lo=None, flat_cap=None):
        """``encode_final`` with the emission and packing dispatched op by
        op after the rate loop (which replays its own graphs on the
        card): what the CPU runs, and on the card the yardstick of the
        captured emission."""
        return self._final_eager(xr, ratio_l, ratio_s, block_type, budget,
                                 payload_words, scfsi, sf_fix, nch, qss_lo,
                                 flat_cap)

    def _final_eager(self, xr, ratio_l, ratio_s, block_type, budget,
                     payload_words, scfsi, sf_fix, nch, qss_lo, flat_cap):
        args = self._final_args(xr, ratio_l, ratio_s, block_type, budget,
                                scfsi, sf_fix, nch, qss_lo)
        out = loop.outer_loop(ST=self.tables("st"), **args)
        return self._emission(out, args, payload_words, flat_cap)

    @span("encode_segment_fused")
    def forward(self, blocks_h4, fsm_init, size_in, payload_words, nch,
                flat_cap, n_real, mean_bits, resv_max, mode_gr, delta):
        """encode_segment_fused: analysis + demand -> reservoir scan
        (carried level in, level out) -> final encode + compacted payload.
        Padded frames past n_real are masked out of the scan and their
        budget rows stay at 4095.  The carry, fsm_init (nch,) and size_in
        (), may be tensors or numpy values (such as the carry a JAX
        segment returned); it comes back as tensors on the device,
        fsm_state (nch,) and size () int32.

        On a CUDA tensor the whole program (``_segment``) replays one
        CUDA graph, captured on its key's first call (``SEGMENTS``: the
        inputs' layout, payload_words, flat_cap, mean_bits, resv_max,
        mode_gr, delta, nch and the tables' identity; stage "segment");
        n_real is an input of the graph, not part of its key.  The
        caller gets clones of its static outputs, and nothing in the call
        waits on the host once the graph is captured; a capture or replay
        error raises.  On any other device it is
        ``encode_segment_staged``."""
        dev = blocks_h4.device
        if dev.type != "cuda":
            return self._staged(blocks_h4, fsm_init, size_in, payload_words,
                                nch, flat_cap, n_real, mean_bits, resv_max,
                                mode_gr, delta)
        inputs = _segment_inputs(blocks_h4, fsm_init, size_in, n_real)
        params = _segment_params(payload_words, flat_cap, mean_bits,
                                 resv_max, mode_gr, delta, nch)
        return graphs.on_stream(
            dev, lambda: self._run_segment(inputs, params,
                                           graphs.cuda_graph(dev),
                                           search.device_buffers(dev)),
            lambda entry: {k: v.clone()
                           for k, v in entry.outputs["segment"].items()})

    encode_segment_fused = forward

    def _run_segment(self, inputs, params, record, refs=()):
        """``forward``'s host side (``graphs.run`` of ``_segment``) on the
        current stream: (entry, the entries the cache dropped).  The
        entry keeps the tables, the iterations' sum and `refs` (K3's
        buffers and counter) alive."""
        tables = tuple(self.tables(g)
                       for g in ("st", "psy", "dsp", "l3", "bits"))
        acc = loop.iterations_on(inputs["blocks_h4"].device)
        return graphs.run(
            SEGMENTS, (graphs.key_of(inputs, *tables), params), "segment",
            inputs, lambda i: self._segment(i, *params), record,
            refs=tables + (acc,) + tuple(refs))

    def _segment(self, inputs, payload_words, flat_cap, mean_bits, resv_max,
                 mode_gr, delta, nch):
        """The segment program as one function of tensors (``forward``'s
        inputs by name: blocks_h4 (nch, 4+n_pad, 576) int16, fsm_init
        (nch,) int32, size_in () int32, n_real () int32): the batched
        analysis, the demand rate loop at 4095 bits (``loop.unrolled``),
        the scan of its demand (K4 on the card), the final budgets, the
        final rate loop and the emission and packing.  It reads no device
        value on the host and builds no tensor from host data, so that a
        CUDA graph can capture it whole; n_real's validity masks are
        made from the tensor on the device.  Its outputs equal
        ``encode_segment_staged``'s."""
        ST = self.tables("st")
        ana = self._analysis(inputs["blocks_h4"], inputs["fsm_init"])
        ana = self._demand_outputs(
            ana, loop.unrolled(_demand_args(ana), ST, MAX_ITER), nch)
        n_real = inputs["n_real"]
        demand, bud, size_out = _scan(ana, inputs["size_in"], n_real, nch,
                                      mean_bits, resv_max, mode_gr, delta)
        target, row = final_budgets(demand, bud, n_real, nch, mode_gr)
        args = self._final_args(ana["xr"], ana["ratio_l"], ana["ratio_s"],
                                ana["block_type"], row, ana.get("scfsi"),
                                ana.get("sf_fix"), nch, ana["qss"])
        h = self._emission(loop.unrolled(args, ST, MAX_ITER), args,
                           payload_words, flat_cap)
        return _segment_outputs(ana, h, target, demand, size_out)

    @span("encode_segment_fused")
    def encode_segment_staged(self, blocks_h4, fsm_init, size_in,
                              payload_words, nch, flat_cap, n_real,
                              mean_bits, resv_max, mode_gr, delta):
        """``forward`` in stages: ``analyze_demand_fused`` (the analysis
        graph and the rate loop's graphs on the card), the scan and the
        final budgets op by op, and ``encode_final`` (the rate loop's
        graphs and the emission graph).  What the CPU runs, and on the
        card the yardstick of the one graph (``tools.yardstick_form``)."""
        return self._staged(blocks_h4, fsm_init, size_in, payload_words, nch,
                            flat_cap, n_real, mean_bits, resv_max, mode_gr,
                            delta)

    def _staged(self, blocks_h4, fsm_init, size_in, payload_words, nch,
                flat_cap, n_real, mean_bits, resv_max, mode_gr, delta):
        fsm_init = torch.as_tensor(fsm_init, dtype=torch.int32,
                                   device=blocks_h4.device)
        ana = self.analyze_demand_fused(blocks_h4, fsm_init)
        demand, bud, size_out = _scan(ana, size_in, n_real, nch, mean_bits,
                                      resv_max, mode_gr, delta)
        target, row = final_budgets(demand, bud, n_real, nch, mode_gr)
        h = self.encode_final(ana["xr"], ana["ratio_l"], ana["ratio_s"],
                              ana["block_type"], row,
                              payload_words=payload_words,
                              scfsi=ana.get("scfsi"),
                              sf_fix=ana.get("sf_fix"), nch=nch,
                              qss_lo=ana["qss"], flat_cap=flat_cap)
        return _segment_outputs(ana, h, target, demand, size_out)


def _demand_args(ana):
    """The demand encode's rate-loop arguments by name (``loop._inputs``):
    the analysis' spectrum at a 4095-bit budget a granule."""
    budget = torch.full((ana["xr"].shape[0],), 4095.0,
                        device=ana["xr"].device)
    return loop._inputs(ana["xr"], budget, ana["ratio_l"], ana["ratio_s"],
                        ana["block_type"] != mpeg.NORM_TYPE,
                        ana["block_type"], None, None, None, None)


def _scan(ana, size_in, n_real, nch, mean_bits, resv_max, mode_gr, delta):
    """The reservoir scan of a segment's demand (``resv.scan_budgets``:
    one K4 launch on the card), frames from n_real on (an int, or a ()
    tensor on the device) masked out.  Returns (demand (nch, n_pad),
    budgets (F, R), the level after)."""
    pe = ana["pe"].reshape(nch, -1)
    demand = ana["p23"].reshape(nch, -1)
    valid_f = torch.arange(pe.shape[1] // mode_gr, device=pe.device) \
        < (n_real // mode_gr)
    bud, size_out = resv.scan_budgets(
        resv.granule_major(pe, nch, mode_gr),
        resv.granule_major(demand, nch, mode_gr), size_in, mean_bits,
        resv_max, mode_gr, nch, delta, valid=valid_f)
    return demand, bud, size_out


def _segment_outputs(ana, h, target, demand, size_out):
    """The segment program's outputs: the final encode's side table and
    payload, the carry, the scan's target and demand, and what
    ``encoder._Layer3Framing.settle`` re-encodes from."""
    out = dict(side=h["side"], payload=h["payload"],
               fsm_state=ana["fsm_state"], size=size_out, target=target,
               demand=demand, n_nonfinite=ana["n_nonfinite"], xr=ana["xr"],
               ratio_l=ana["ratio_l"], ratio_s=ana["ratio_s"],
               block_type=ana["block_type"], qss=ana["qss"])
    if "scfsi" in ana:
        out["scfsi"] = ana["scfsi"]
        out["sf_fix"] = ana["sf_fix"]
    return out


def _segment_inputs(blocks_h4, fsm_init, size_in, n_real):
    """The one graph's inputs by name, on blocks_h4's device: the carry
    and n_real as int32 tensors (a Python value filled in on the device,
    not uploaded)."""
    dev = blocks_h4.device
    return dict(blocks_h4=blocks_h4,
                fsm_init=torch.as_tensor(fsm_init, dtype=torch.int32,
                                         device=dev),
                size_in=resv._level(size_in, dev),
                n_real=resv._level(n_real, dev))


def _segment_params(payload_words, flat_cap, mean_bits, resv_max, mode_gr,
                    delta, nch):
    """The constants of a segment program, part of its graph's key:
    (payload_words, flat_cap, mean_bits, resv_max, mode_gr, delta, nch)
    as Python ints (flat_cap may be None)."""
    return (int(payload_words), None if flat_cap is None else int(flat_cap),
            int(mean_bits), int(resv_max), int(mode_gr), int(delta), int(nch))
