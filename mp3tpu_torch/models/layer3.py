"""Layer III segment encoder (port of mp3tpu/models/layer3.py).

``Layer3SegmentEncoder`` is the segment program for one
(version, sampling_frequency): analysis + demand encode -> reservoir
scan -> final encode + on-device emission and packing.  Its constant
matrices and lookup tables are buffers, built from the port's ``tables`` or
loaded from the JAX package's own numpy constants.

Quality deviations from the reference are those of the JAX package:
true quantization range, psy outputs used for the granule they were
computed on, and scfsi with the intended per-channel indexing.
"""
import numpy as np
import torch
from torch import nn

from ..tables import mpeg

from ..ops import bits, dsp, loop, psy, resv
from ..runtime.profiling import span

#: sfb -> scfsi band map (loop.c scfsi_band_long 0,6,11,16,21)
BAND_OF_SFB = np.repeat(np.arange(4), np.diff(mpeg.SCFSI_BAND_LONG))


def _scfsi_flags(xr, ratio_l, ratio_s, block_type, ST):
    """scfsi decision for one channel's granule batch (loop.c:615-720,
    with the intended per-channel indexing).  xr (C, 576): granule pairs
    are (2f, 2f+1).  Returns (C//2, 4) int32 flags."""
    xr_abs = xr.abs()
    xmin_l, _ = loop.calc_xmin(xr_abs, ratio_l, ratio_s, ST)
    en_sfb = (xr_abs * xr_abs) @ ST["oh_l"]                 # (C, 21)
    ln2 = float(np.log(2.0))
    en = torch.where(en_sfb > 0,
                     torch.trunc(torch.log(torch.clamp(en_sfb, min=1e-37))
                                 / ln2), 0.0)
    xm = torch.where(xmin_l > 0,
                     torch.trunc(torch.log(torch.clamp(xmin_l, min=1e-37))
                                 / ln2), 0.0)
    # reference scale: xr in int16 units; int(max|xr|) != 0
    nonsilent = xr_abs.amax(dim=1) * 32768.0 >= 1.0
    long_ok = block_type != 2
    en0, en1 = en[0::2], en[1::2]
    xm0, xm1 = xm[0::2], xm[1::2]
    cond = (nonsilent[0::2] & nonsilent[1::2] & long_ok[0::2]
            & long_ok[1::2] & ((en0 - en1).abs().sum(dim=1) < 100.0))
    band_oh = torch.as_tensor(
        (np.arange(4)[None, :] == BAND_OF_SFB[:, None]).astype(np.float32),
        device=xr.device)                                   # (21, 4)
    den = (en0 - en1).abs() @ band_oh
    dxm = (xm0 - xm1).abs() @ band_oh
    return (cond[:, None] & (den < 10.0) & (dxm < 10.0)).to(torch.int32)


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
        self.load_numpy_constants(dict(
            static=loop.static_tables(version, sampling_frequency),
            dsp=dsp.numpy_constants(),
            **psy.numpy_constants(self.sfreq_hz)), device=device)

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
        """The `group` ("st", "psy", "dsp" or "bits") tables as a dict."""
        return {k: getattr(self, f"{group}_{k}") for k in self._groups[group]}

    def load_numpy_constants(self, d, device=None):
        """Make the buffers from numpy constants in the JAX package's form:
        d["static"] (jaxloop._static), d["psy_mats"] (jaxpsy._psy_mats),
        d["dft"] {n: jaxpsy._dft_mats(n)}, d["hann"] {n: jaxpsy._hann(n)},
        d["dsp"] {"enwindow_rev", "ana_filter_rev", "basis_long",
        "basis_short", "alias"} (jaxdsp._ENWINDOW_REV, ...)."""
        if device is None:
            device = self.st_oh_l.device
        self._register("st", loop.device_tables(d["static"], device))
        self._register("psy", psy.device_tables(d, device))
        self._register("dsp", dsp.device_tables(d["dsp"], device))
        self._register("bits", bits.device_tables(device))
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
        """Filterbank + MDCT of one channel's chunk (2 warmup + C blocks)
        at its C block types: xr (C, 576)."""
        DT = self.tables("dsp")
        scaled = blocks_ext / 32768.0
        sb = dsp.subband_granules(scaled[2:], scaled[1, 64:], DT)
        sb_prev = dsp.subband_granules(scaled[1][None], scaled[0, 64:],
                                       DT)[0]
        return dsp.mdct_granules(sb, sb_prev, block_type, DT)

    @span("analyze_demand_fused")
    def analyze_demand_fused(self, blocks_h4, fsm_init):
        """Analysis + unconstrained (4095-bit) demand encode of a segment.

        blocks_h4 (nch, 4+S, 576) int16-valued; rows 0:2 psy halo, rows
        2:4 warmup granules.  fsm_init (nch,) int.  Returns xr (nch*S,
        576) and its rate-loop inputs, pe, p23 (demand), qss (warm lower
        bound for the final encode), fsm_state, n_nonfinite, and for
        MPEG-1 the scfsi flags with the demand granule-0 scalefactors."""
        ST = self.tables("st")
        nch = blocks_h4.shape[0]
        S = blocks_h4.shape[1] - 4
        blocks = blocks_h4.to(torch.float32)
        anas = [self._analyze_chunk(blocks[ch, 2:], blocks[ch, :2],
                                    fsm_init[ch]) for ch in range(nch)]
        fsm_state = torch.stack([a.pop("fsm_state") for a in anas])
        ana = {k: torch.cat([a[k] for a in anas]) for k in anas[0]}
        # NaN/Inf guard: a granule whose analysis went non-finite is
        # degraded to silence instead of poisoning the rate loop
        finite = (torch.isfinite(ana["xr"]).all(dim=1)
                  & torch.isfinite(ana["pe"])
                  & torch.isfinite(ana["ratio_l"]).all(dim=1)
                  & torch.isfinite(ana["ratio_s"]).flatten(1).all(dim=1))
        ana["xr"] = torch.where(finite[:, None], ana["xr"], 0.0)
        ana["pe"] = torch.where(finite, ana["pe"], 0.0)
        ana["ratio_l"] = torch.where(finite[:, None], ana["ratio_l"], 0.0)
        ana["ratio_s"] = torch.where(finite[:, None, None], ana["ratio_s"],
                                     0.0)
        budget = torch.full((nch * S,), 4095.0, device=blocks.device)
        out = loop.outer_loop(ana["xr"], budget, ana["ratio_l"],
                              ana["ratio_s"],
                              ana["block_type"] != mpeg.NORM_TYPE,
                              ana["block_type"], ST)
        res = dict(
            xr=ana["xr"], ratio_l=ana["ratio_l"], ratio_s=ana["ratio_s"],
            block_type=ana["block_type"], pe=ana["pe"],
            p23=out["part2_3_length"].to(torch.int32),
            qss=out["qss0"].to(torch.float32), fsm_state=fsm_state,
            n_nonfinite=(~finite).sum().to(torch.int32))
        if not ST["lsf"]:
            res["scfsi"] = torch.stack([
                _scfsi_flags(a["xr"], a["ratio_l"], a["ratio_s"],
                             a["block_type"], ST) for a in anas])
            res["sf_fix"] = out["sf_l"].reshape(nch, S, 21)[:, 0::2] \
                .to(torch.int8)
        return res

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
        flat_cap, the compacted (flat_cap,) buffer)."""
        ST = self.tables("st")
        is_short_block = block_type != mpeg.NORM_TYPE
        is_short = is_short_block & (block_type == 2)
        mask = vals = skipm = None
        if scfsi is not None and sf_fix is not None and not ST["lsf"]:
            N = xr.shape[0]
            C = N // nch
            band_idx = torch.as_tensor(BAND_OF_SFB, device=xr.device)
            band = scfsi.reshape(nch, C // 2, 4).bool()[:, :, band_idx]
            mask = band.repeat_interleave(2, dim=1).reshape(N, 21)
            vals = sf_fix.reshape(nch, C // 2, 21) \
                .repeat_interleave(2, dim=1).reshape(N, 21)
            odd = (torch.arange(C, device=xr.device) % 2) == 1
            skipm = mask & odd.repeat(nch)[:, None]
        out = loop.outer_loop(xr, budget, ratio_l, ratio_s, is_short_block,
                              block_type, ST, sf_fix_mask=mask,
                              sf_fix_val=vals, sf_skip_mask=skipm,
                              qss_lo=qss_lo)
        ix_signed = torch.where((xr < 0) & (out["ix"] > 0), -out["ix"],
                                out["ix"])
        payload, nbits = bits.granule_payload(
            out, ix_signed, is_short, ST, self.tables("bits"),
            payload_words, skip_mask=skipm)
        if flat_cap is not None:
            payload = bits.compact_payload(payload, nbits, flat_cap)
        return dict(side=pack_state(out, block_type), payload=payload)

    @span("encode_segment_fused")
    def forward(self, blocks_h4, fsm_init, size_in, payload_words, nch,
                flat_cap, n_real, mean_bits, resv_max, mode_gr, delta):
        """encode_segment_fused: analysis + demand -> reservoir scan
        (carried level in, level out) -> final encode + compacted payload.
        Padded frames past n_real are masked out of the scan and their
        budget rows stay at 4095.  The carry, fsm_init (nch,) and size_in
        (), may be tensors or numpy values (such as the carry a JAX
        segment returned)."""
        dev = blocks_h4.device
        fsm_init = torch.as_tensor(fsm_init, dtype=torch.int32, device=dev)
        ana = self.analyze_demand_fused(blocks_h4, fsm_init)
        n_pad = blocks_h4.shape[1] - 4
        pe = ana["pe"].reshape(nch, -1)
        demand = ana["p23"].reshape(nch, -1)
        valid_f = torch.arange(n_pad // mode_gr, device=dev) \
            < (n_real // mode_gr)
        bud, size_out = resv.scan_budgets(
            resv.granule_major(pe, nch, mode_gr),
            resv.granule_major(demand, nch, mode_gr),
            size_in, mean_bits, resv_max, mode_gr, nch, delta,
            valid=valid_f)
        target, row = final_budgets(demand, bud, n_real, nch, mode_gr)
        h = self.encode_final(ana["xr"], ana["ratio_l"], ana["ratio_s"],
                              ana["block_type"], row,
                              payload_words=payload_words,
                              scfsi=ana.get("scfsi"),
                              sf_fix=ana.get("sf_fix"), nch=nch,
                              qss_lo=ana["qss"], flat_cap=flat_cap)
        out = dict(side=h["side"], payload=h["payload"],
                   fsm_state=ana["fsm_state"], size=size_out,
                   target=target, demand=demand,
                   n_nonfinite=ana["n_nonfinite"], xr=ana["xr"],
                   ratio_l=ana["ratio_l"], ratio_s=ana["ratio_s"],
                   block_type=ana["block_type"], qss=ana["qss"])
        if "scfsi" in ana:
            out["scfsi"] = ana["scfsi"]
            out["sf_fix"] = ana["sf_fix"]
        return out

    encode_segment_fused = forward
