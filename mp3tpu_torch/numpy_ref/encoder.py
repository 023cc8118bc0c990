"""Layer III end-to-end oracle encoder (frame loop of musicin.c:708-805).

Batched DSP/psy up front (they are granule-parallel), then the
sequential per-granule rate loop with exact reservoir semantics, then
byte-exact bitstream assembly.
"""
import copy

import numpy as np

from ..config import EncoderConfig
from ..tables import mpeg
from . import bitstream as BS
from . import dsp, loop, psy
from .reservoir import Reservoir


def _calc_scfsi_state():
    return dict(en_tot=np.zeros((2, 2), np.int64),
                en=np.zeros((2, 2, 21), np.int64),
                xm=np.zeros((2, 2, 21), np.int64),
                xrmax=np.zeros((2, 2), np.int64))


def _calc_scfsi(xr, st, xmin_l, gi, ch, gr, scfsi_out, sfb_l):
    """loop.c:615-720 with its indexing quirks kept (see comments)."""
    import math
    from .loop import _seqsum
    log2 = math.log(2.0)
    st["xrmax"][gr][ch] = int(np.max(np.abs(xr)))  # double->int truncation
    temp = _seqsum(xr * xr)
    st["en_tot"][gr][ch] = 0 if temp == 0.0 else int(math.log(temp) / log2)

    if gi.window_switching_flag == 0 or gi.block_type != 2:
        for sfb in range(21):
            start, end = int(sfb_l[sfb]), int(sfb_l[sfb + 1])
            t = _seqsum(xr[start:end] * xr[start:end])
            st["en"][gr][ch][sfb] = 0 if t == 0.0 else int(math.log(t) / log2)
            st["xm"][gr][ch][sfb] = 0 if xmin_l[sfb] == 0.0 else int(math.log(xmin_l[sfb]) / log2)
    if gr == 1:
        condition = 0
        for gr2 in range(2):
            # note transposed index [ch][gr2], as in loop.c:676
            if st["xrmax"][ch][gr2] != 0:
                condition += 1
            if gi.window_switching_flag == 0 or gi.block_type != 2:
                condition += 1
        # loop.c:683 compares decayed array pointers -- always true
        condition += 1
        tp = int(np.sum(np.abs(st["en"][ch][0] - st["en"][ch][1])))
        if tp < 100:
            condition += 1
        if condition == 6:
            for band in range(4):
                s, e = int(mpeg.SCFSI_BAND_LONG[band]), int(mpeg.SCFSI_BAND_LONG[band + 1])
                sum0 = int(np.sum(np.abs(st["en"][ch][0][s:e] - st["en"][ch][1][s:e])))
                sum1 = int(np.sum(np.abs(st["xm"][ch][0][s:e] - st["xm"][ch][1][s:e])))
                scfsi_out[ch][band] = 1 if (sum0 < 10 and sum1 < 10) else 0
        else:
            for band in range(4):
                scfsi_out[ch][band] = 0


def encode_layer3(pcm, cfg: EncoderConfig, return_debug=False):
    """Encode int16 PCM to an MP3 byte string.

    pcm: (nsamples, nch) or (nsamples,) int16-valued array.
    """
    cfg.finalize()
    assert cfg.layer == 3
    pcm = np.atleast_2d(np.asarray(pcm, np.int64))
    if pcm.shape[0] > pcm.shape[1]:
        pcm = pcm.T  # -> (nch, nsamples)
    nch = cfg.nchannels
    assert pcm.shape[0] == nch
    version = cfg.version
    mode_gr = cfg.mode_gr
    spf = cfg.samples_per_frame
    sfreq = float(mpeg.S_FREQ_KHZ[version][cfg.sampling_frequency]) * 1000.0
    sfb_l = mpeg.sfb_long(version, cfg.sampling_frequency)
    sfb_s = mpeg.sfb_short(version, cfg.sampling_frequency)

    nframes = int(np.ceil(pcm.shape[1] / spf))
    total = nframes * spf
    pcm = np.pad(pcm, ((0, 0), (0, total - pcm.shape[1])))
    G = nframes * mode_gr

    # ---- batched psy + DSP per channel
    psy_out = [psy.psycho_granules(pcm[ch], sfreq) for ch in range(nch)]
    xr_all = []
    for ch in range(nch):
        sb = dsp.granule_subbands(pcm[ch] / 32768.0, G)
        xr_all.append(dsp.mdct_granules(sb, psy_out[ch]["block_type"]))

    whole_spf, frac = cfg.slots_per_frame()
    padding = cfg.padding_sequence(nframes)
    sideinfo_len = mpeg.sideinfo_bits(version, nch, cfg.error_protection)

    resv = Reservoir()
    asm = BS.FrameAssembler()
    main_data_begin = 0
    scfsi = [[0] * 4 for _ in range(2)]
    debug = []
    # gr_info structs persist across frames in the reference (static
    # l3_side); only the fields listed at loop.c:316-344 are reset per
    # granule.  address1/2/3 deliberately survive (see subdivide).
    persistent_gi = [[loop.GrInfo() for _ in range(nch)] for _ in range(2)]

    for f in range(nframes):
        bits_per_frame = 8 * whole_spf + int(padding[f]) * 8
        mean_bits = (bits_per_frame - sideinfo_len) // mode_gr
        resv.frame_begin(version, bits_per_frame, main_data_begin)
        resv_drain = 0

        st = _calc_scfsi_state()
        gis = [[None] * nch for _ in range(mode_gr)]
        ixs = [[None] * nch for _ in range(mode_gr)]
        sfl = [[None] * nch for _ in range(mode_gr)]
        sfs = [[None] * nch for _ in range(mode_gr)]
        xr_orig = [[None] * nch for _ in range(mode_gr)]

        for gr in range(mode_gr):
            for ch in range(nch):
                g = f * mode_gr + gr
                p = psy_out[ch]
                gi = persistent_gi[gr][ch]
                gi.part2_3_length = 0
                gi.big_values = 0
                gi.count1 = 0
                gi.scalefac_compress = 0
                gi.table_select = [0, 0, 0]
                gi.subblock_gain = [0, 0, 0]
                gi.region0_count = 0
                gi.region1_count = 0
                gi.part2_length = 0
                gi.preflag = 0
                gi.scalefac_scale = 0
                gi.quantizerStepSize = 0.0
                gi.count1table_select = 0
                gi.slen = [0, 0, 0, 0]
                gi.sfb_partition_table = 0
                gi.block_type = int(p["block_type"][g])
                gi.window_switching_flag = 0 if gi.block_type == mpeg.NORM_TYPE else 1
                gi.mixed_block_flag = 0
                loop.gr_deco(gi)
                xr = xr_all[ch][g].copy()
                xr_orig[gr][ch] = xr_all[ch][g]
                xmin_l, xmin_s = loop.calc_xmin(
                    xr, p["ratio_l"][g], p["ratio_s"][g], gi, sfb_l, sfb_s)
                if version == mpeg.MPEG1:
                    _calc_scfsi(xr, st, xmin_l, gi, ch, gr, scfsi, sfb_l)
                max_bits = resv.max_bits(p["pe"][g], mean_bits, nch)

                scalefac_l = np.zeros(22, np.int64)
                scalefac_s = np.zeros((13, 3), np.int64)
                ix = np.zeros(576, np.int64)
                if np.max(np.abs(xr)) != 0.0:
                    gi.quantizerStepSize = loop.quantanf_init(xr)
                    gr0 = gis[0][ch] if gr == 1 else gi
                    sl_gr0 = sfl[0][ch] if gr == 1 else scalefac_l
                    ix = loop.outer_loop(
                        xr, max_bits, xmin_l, xmin_s, gi, gr0, gr,
                        scfsi[ch] if gr == 1 else [0, 0, 0, 0],
                        scalefac_l, scalefac_s, sl_gr0, version, sfb_l, sfb_s)
                resv.adjust(mean_bits, nch, gi.part2_3_length)
                gi.global_gain = loop.nint(gi.quantizerStepSize + 210.0)
                assert gi.global_gain < 256
                gis[gr][ch] = gi
                ixs[gr][ch] = ix
                sfl[gr][ch] = scalefac_l
                sfs[gr][ch] = scalefac_s

        flat = [gis[gr][ch] for gr in range(mode_gr) for ch in range(nch)]
        resv_drain = resv.frame_end(flat, mean_bits, nch, mode_gr)

        # ---- assemble this frame
        si = BS.encode_header(cfg, int(padding[f]))
        side = dict(main_data_begin=main_data_begin,
                    private_bits=cfg.private_bits, scfsi=scfsi, granules=gis)
        si += BS.encode_side_info(cfg, side)
        if cfg.error_protection:
            si = BS.insert_crc16(si)
        main = []
        for gr in range(mode_gr):
            for ch in range(nch):
                gi = gis[gr][ch]
                ix_signed = ixs[gr][ch].copy()
                neg = (xr_orig[gr][ch] < 0) & (ix_signed > 0)
                ix_signed[neg] *= -1
                main += BS.encode_scalefacs(gi, sfl[gr][ch], sfs[gr][ch],
                                            scfsi[ch], gr, version)
                main += BS.encode_spectrum(gi, ix_signed, sfb_s)
        if resv_drain:
            r = resv_drain
            while r >= 32:
                main.append((0, 32))
                r -= 32
            if r:
                main.append((0, r))
        main_data_begin, _ = asm.add_frame(bits_per_frame, si, main)
        if return_debug:
            debug.append(dict(gis=copy.deepcopy(gis), ix=ixs, scalefac_l=sfl, scalefac_s=sfs,
                              scfsi=[list(s) for s in scfsi],
                              mdb=main_data_begin, resv_drain=resv_drain))

    out = asm.flush()
    if return_debug:
        return out, debug
    return out
