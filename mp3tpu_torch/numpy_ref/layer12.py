"""Layer I/II encoder oracle: byte-exact replica of the reference's
Layer 1/2 paths (musicin.c:621-705 + encode.c), used as the golden
test anchor for the TPU fast path.

Pipeline per frame (Layer II; Layer I is the 384-sample, single-group
variant):
  polyphase filterbank (encode.c:287-409, shared with Layer III)
  -> scale factors (encode.c:536-557) + scfsi pattern (encode.c:626-679)
  -> [joint] mono combine + mono scale factors (encode.c:480-492)
  -> psy model 2 -> 32 subband SNRs (psy.c, see psy12)
  -> greedy min-MNR bit allocation w/ joint-stereo mode_ext reduction
     (encode.c:810-1173)
  -> CRC (common.c:1251-1308), header, bit alloc, scale factors,
     a*x+b quantization (encode.c:1264-1321), grouped sample packing
     (encode.c:1401-1431), zero ancillary fill.
"""
import numpy as np

from . import psy12
from .bitstream import BitWriter
from .dsp import subband_filter_stream
from ..tables import layer12 as T
from ..tables import mpeg

SBLIMIT = 32
SCALE_BLOCK = 12


def _scale_factor_calc(sb, sblimit):
    """encode.c:536-557 vectorized: index of the smallest multiple[]
    >= the subband peak; sb: (..., 12, sblimit'...) grouped later.
    sb shape (T, 12, 32) -> (T, 32) indices over axis of 12 samples."""
    s = np.abs(sb).max(axis=-2)
    # scalar = max j in [0,62] with s <= multiple[j] (multiple is
    # descending); 0 if s > multiple[0] (loop default, encode.c:551)
    mult = mpeg.MULTIPLE[:63]
    idx = np.searchsorted(-mult, -s, side="right") - 1
    idx = np.clip(idx, 0, 62)
    out = np.full(s.shape, 63, np.int64)
    out[..., :sblimit] = idx[..., :sblimit]
    return out


def _transmission_pattern(scalar, sblimit):
    """encode.c:626-679.  scalar: (3, 32) per channel; returns scfsi
    (32,) and mutates scalar per the pattern."""
    scfsi = np.zeros(SBLIMIT, np.int64)
    for i in range(sblimit):
        d0 = scalar[0][i] - scalar[1][i]
        d1 = scalar[1][i] - scalar[2][i]
        cls = []
        for d in (d0, d1):
            if d <= -3:
                cls.append(0)
            elif d < 0:
                cls.append(1)
            elif d == 0:
                cls.append(2)
            elif d < 3:
                cls.append(3)
            else:
                cls.append(4)
        pat = T.SCFSI_PATTERN[cls[0]][cls[1]]
        if pat == 0x123:
            scfsi[i] = 0
        elif pat == 0x122:
            scfsi[i] = 3
            scalar[2][i] = scalar[1][i]
        elif pat == 0x133:
            scfsi[i] = 3
            scalar[1][i] = scalar[2][i]
        elif pat == 0x113:
            scfsi[i] = 1
            scalar[1][i] = scalar[0][i]
        elif pat == 0x111:
            scfsi[i] = 2
            scalar[1][i] = scalar[2][i] = scalar[0][i]
        elif pat == 0x222:
            scfsi[i] = 2
            scalar[0][i] = scalar[2][i] = scalar[1][i]
        elif pat == 0x333:
            scfsi[i] = 2
            scalar[0][i] = scalar[1][i] = scalar[2][i]
        elif pat == 0x444:
            scfsi[i] = 2
            if scalar[0][i] > scalar[2][i]:
                scalar[0][i] = scalar[2][i]
            scalar[1][i] = scalar[2][i] = scalar[0][i]
    return scfsi


def _bits_for_nonoise_II(perm_smr, scfsi, nch, sblimit, jsbound, alloc,
                         error_protection):
    """encode.c:810-860."""
    snr = T.SNR_L2
    bbal = 0
    for sb in range(jsbound):
        bbal += nch * alloc["nbal"][sb]
    for sb in range(jsbound, sblimit):
        bbal += alloc["nbal"][sb]
    req = 32 + bbal + (16 if error_protection else 0)
    for sb in range(sblimit):
        for ch in range(nch if sb < jsbound else 1):
            max_alloc = (1 << alloc["nbal"][sb]) - 1
            ba = 0
            while ba < max_alloc - 1:
                if (-perm_smr[ch][sb]
                        + snr[alloc["quant"][sb][ba] + (1 if ba > 0 else 0)]
                        >= T.NOISY_MIN_MNR):
                    break
                ba += 1
            if nch == 2 and sb >= jsbound:
                while ba < max_alloc - 1:
                    if (-perm_smr[1 - ch][sb]
                            + snr[alloc["quant"][sb][ba]
                                  + (1 if ba > 0 else 0)]
                            >= T.NOISY_MIN_MNR):
                        break
                    ba += 1
            if ba > 0:
                smp = SCALE_BLOCK * alloc["group"][sb][ba] * alloc["bits"][sb][ba]
                sel = 2
                sc = 6 * T.SFS_PER_SCFSI[scfsi[ch][sb]]
                if nch == 2 and sb >= jsbound:
                    sel += 2
                    sc += 6 * T.SFS_PER_SCFSI[scfsi[1 - ch][sb]]
                req += smp + sel + sc
    return req


def _bits_for_nonoise_I(perm_smr, nch, jsbound):
    """encode.c:782-806."""
    snr = T.SNR_L1
    req = 32 + 4 * (jsbound * nch + (SBLIMIT - jsbound))
    for sb in range(SBLIMIT):
        for ch in range(nch if sb < jsbound else 1):
            k = 0
            while k < 14:
                if -perm_smr[ch][sb] + snr[k] >= T.NOISY_MIN_MNR:
                    break
                k += 1
            if nch == 2 and sb >= jsbound:
                while k < 14:
                    if -perm_smr[1 - ch][sb] + snr[k] >= T.NOISY_MIN_MNR:
                        break
                    k += 1
            if k > 0:
                req += (k + 1) * SCALE_BLOCK + 6 * (nch if sb >= jsbound else 1)
    return req


def _a_bit_allocation_II(perm_smr, scfsi, adb, nch, sblimit, jsbound,
                         alloc, error_protection):
    """encode.c:1072-1173 greedy min-MNR water filling.  Returns
    (bit_alloc, adb_left)."""
    snr = T.SNR_L2
    bbal = 0
    for sb in range(jsbound):
        bbal += nch * alloc["nbal"][sb]
    for sb in range(jsbound, sblimit):
        bbal += alloc["nbal"][sb]
    adb -= bbal + (16 if error_protection else 0) + 32
    ad = adb
    mnr = np.zeros((2, SBLIMIT))
    used = np.zeros((2, SBLIMIT), np.int64)
    ba_arr = np.zeros((2, SBLIMIT), np.int64)
    for sb in range(sblimit):
        for ch in range(nch):
            mnr[ch][sb] = snr[0] - perm_smr[ch][sb]
    bspl = bscf = bsel = 0
    while True:
        small = 999999.0
        min_sb = min_ch = -1
        for sb in range(sblimit):
            for ch in range(nch):
                if used[ch][sb] != 2 and small > mnr[ch][sb]:
                    small = mnr[ch][sb]
                    min_sb, min_ch = sb, ch
        if min_sb < 0:
            break
        cur = ba_arr[min_ch][min_sb]
        inc = SCALE_BLOCK * (alloc["group"][min_sb][cur + 1]
                             * alloc["bits"][min_sb][cur + 1])
        if used[min_ch][min_sb]:
            inc -= SCALE_BLOCK * (alloc["group"][min_sb][cur]
                                  * alloc["bits"][min_sb][cur])
        oth = 1 - min_ch
        if used[min_ch][min_sb]:
            scale = seli = 0
        else:
            seli = 2
            scale = 6 * T.SFS_PER_SCFSI[scfsi[min_ch][min_sb]]
            if nch == 2 and min_sb >= jsbound:
                seli += 2
                scale += 6 * T.SFS_PER_SCFSI[scfsi[oth][min_sb]]
        if ad >= bspl + bscf + bsel + seli + scale + inc:
            ba_arr[min_ch][min_sb] += 1
            ba = ba_arr[min_ch][min_sb]
            bspl += inc
            bscf += scale
            bsel += seli
            used[min_ch][min_sb] = 1
            mnr[min_ch][min_sb] = (-perm_smr[min_ch][min_sb]
                                   + snr[alloc["quant"][min_sb][ba] + 1])
            if ba >= (1 << alloc["nbal"][min_sb]) - 1:
                used[min_ch][min_sb] = 2
        else:
            used[min_ch][min_sb] = 2
        if min_sb >= jsbound and nch == 2:
            ba = ba_arr[min_ch][min_sb]
            ba_arr[oth][min_sb] = ba
            used[oth][min_sb] = used[min_ch][min_sb]
            mnr[oth][min_sb] = (-perm_smr[oth][min_sb]
                                + snr[alloc["quant"][min_sb][ba] + 1])
    ad -= bspl + bscf + bsel
    return ba_arr, ad


def _a_bit_allocation_I(perm_smr, adb, nch, jsbound, error_protection):
    """encode.c:983-1068."""
    snr = T.SNR_L1
    bbal = 4 * (jsbound * nch + (SBLIMIT - jsbound))
    adb -= bbal + (16 if error_protection else 0) + 32
    ad = adb
    mnr = np.zeros((2, SBLIMIT))
    used = np.zeros((2, SBLIMIT), np.int64)
    ba_arr = np.zeros((2, SBLIMIT), np.int64)
    for sb in range(SBLIMIT):
        for ch in range(nch):
            mnr[ch][sb] = snr[0] - perm_smr[ch][sb]
    bspl = bscf = 0
    while True:
        small = mnr[0][0] + 1
        min_sb = min_ch = -1
        for sb in range(SBLIMIT):
            for ch in range(nch):
                if used[ch][sb] != 2 and small > mnr[ch][sb]:
                    small = mnr[ch][sb]
                    min_sb, min_ch = sb, ch
        if min_sb < 0:
            break
        if used[min_ch][min_sb]:
            smpl, scale = SCALE_BLOCK, 0
        else:
            smpl, scale = 24, 6
        if min_sb >= jsbound:
            scale *= nch
        if ad >= bspl + bscf + scale + smpl:
            bspl += smpl
            bscf += scale
            ba_arr[min_ch][min_sb] += 1
            used[min_ch][min_sb] = 1
            mnr[min_ch][min_sb] = (-perm_smr[min_ch][min_sb]
                                   + snr[ba_arr[min_ch][min_sb]])
            if ba_arr[min_ch][min_sb] == 14:
                used[min_ch][min_sb] = 2
        else:
            used[min_ch][min_sb] = 2
        if nch == 2 and min_sb >= jsbound:
            oth = 1 - min_ch
            ba_arr[oth][min_sb] = ba_arr[min_ch][min_sb]
            used[oth][min_sb] = used[min_ch][min_sb]
            mnr[oth][min_sb] = (-perm_smr[oth][min_sb]
                                + snr[ba_arr[oth][min_sb]])
    ad -= bspl + bscf
    return ba_arr, ad


def _update_crc(data, length, crc):
    masking = 1 << length
    while True:
        masking >>= 1
        if not masking:
            break
        carry = crc & 0x8000
        crc = (crc << 1) & 0x1FFFF
        if (not carry) ^ (not (data & masking)):
            crc ^= 0x8005
        crc &= 0xFFFF
    return crc


def _crc_calc(cfg, padding, mode, mode_ext, bit_alloc, scfsi, nch,
              sblimit, jsbound, alloc, layer):
    """common.c:1251-1308."""
    crc = 0xFFFF
    crc = _update_crc(cfg.bitrate_index, 4, crc)
    crc = _update_crc(cfg.sampling_frequency, 2, crc)
    crc = _update_crc(padding, 1, crc)
    crc = _update_crc(cfg.extension, 1, crc)
    crc = _update_crc(mode, 2, crc)
    crc = _update_crc(mode_ext, 2, crc)
    crc = _update_crc(int(cfg.copyright), 1, crc)
    crc = _update_crc(int(cfg.original), 1, crc)
    crc = _update_crc(cfg.emphasis, 2, crc)
    if layer == 1:
        for sb in range(SBLIMIT):
            for ch in range(nch if sb < jsbound else 1):
                crc = _update_crc(int(bit_alloc[ch][sb]), 4, crc)
    else:
        for sb in range(sblimit):
            for ch in range(nch if sb < jsbound else 1):
                crc = _update_crc(int(bit_alloc[ch][sb]),
                                  int(alloc["nbal"][sb]), crc)
        for sb in range(sblimit):
            for ch in range(nch):
                if bit_alloc[ch][sb]:
                    crc = _update_crc(int(scfsi[ch][sb]), 2, crc)
    return crc


def _quantize_II(d, qnt, steps):
    """encode.c:1287-1316: a*x+b, truncate, invert MSB."""
    d = d * T.QUANT_A[qnt] + T.QUANT_B[qnt]
    sig = 1 if d >= 0 else 0
    if not sig:
        d += 1.0
    n = 0
    while (1 << n) < steps:
        n += 1
    n -= 1
    v = int(d * float(1 << n))
    if sig:
        v |= 1 << n
    return v


def _quantize_I(d, nbits):
    """encode.c:1228-1259 (layer 1): n = bit_alloc, rearranged a/b."""
    d = d * T.QUANT_A_L1[nbits - 1] + T.QUANT_B_L1[nbits - 1]
    sig = 1 if d >= 0 else 0
    if not sig:
        d += 1.0
    v = int(d * float(1 << nbits))
    if sig:
        v |= 1 << nbits
    return v


def encode(pcm, cfg):
    """Encode int16 PCM to a Layer I or II MPEG audio stream (bytes).

    pcm: (nsamples, nch) or (nsamples,) int16 array.
    cfg: EncoderConfig with layer in (1, 2).
    """
    cfg.finalize()
    layer = cfg.layer
    assert layer in (1, 2)
    pcm = np.atleast_2d(np.asarray(pcm, np.int64))
    if pcm.shape[0] > pcm.shape[1]:
        pcm = pcm.T
    nch = cfg.nchannels
    assert pcm.shape[0] == nch

    sfreq_khz = mpeg.S_FREQ_KHZ[cfg.version][cfg.sampling_frequency]
    sfreq_hz = float(sfreq_khz) * 1000.0
    spf = 384 if layer == 1 else 1152
    bits_per_slot = 32 if layer == 1 else 8
    # a final partial frame is zero-filled and encoded
    # (read_samples, encode.c:162-166)
    nframes = int(np.ceil(pcm.shape[1] / spf))
    pad = nframes * spf - pcm.shape[1]
    if pad:
        pcm = np.concatenate([pcm, np.zeros((nch, pad), pcm.dtype)], axis=1)

    joint = cfg.mode == mpeg.MODE_JOINT
    header_mode = cfg.mode
    table, sblimit = T.pick_table(
        cfg.version, layer, cfg.bitrate_index, cfg.sampling_frequency,
        nch, cfg.bitrate_kbps, float(sfreq_khz))
    alloc = T.ALLOC[table] if table is not None else None
    ngroups = 1 if layer == 1 else 3

    # framing arithmetic: whole slots only (musicin.c:560-567 truncates
    # the fractional part, so padding never fires)
    whole_spf = int((spf / float(sfreq_khz))
                    * (cfg.bitrate_kbps / float(bits_per_slot)))
    adb_frame = whole_spf * bits_per_slot

    # filterbank for the whole clip (stateless, encode.c:287-409).
    # Layer 1's get_audio (encode.c:221-246) keeps a 64-sample
    # look-back in the frame buffer, and window_subband consumes the
    # buffer from position 0 -- so the layer-1 filterbank stream is
    # the PCM delayed by 64 samples (the psy stream is not).
    if layer == 1:
        fb_stream = np.concatenate(
            [np.zeros((nch, 64), pcm.dtype), pcm[:, :-64]], axis=1)
    else:
        fb_stream = pcm
    shifts = nframes * ngroups * SCALE_BLOCK
    sb_all = np.stack([
        subband_filter_stream(fb_stream[ch] / 32768.0, shifts).reshape(
            nframes, ngroups, SCALE_BLOCK, SBLIMIT)
        for ch in range(nch)])          # (nch, F, 3, 12, 32)

    # psy model 2 for the whole clip
    if cfg.psy_model == 2:
        snr = np.stack([psy12.snr32_frames(pcm[ch], layer, sfreq_hz)
                        for ch in range(nch)])   # (nch, F, 32)
    else:
        from . import tonal
        snr = tonal.psycho_one_frames(pcm, layer, cfg, sb_all)

    bs = BitWriter()
    for f in range(nframes):
        sb = sb_all[:, f]               # (nch, 3, 12, 32)
        scalar = _scale_factor_calc(sb, sblimit)   # (nch, 3, 32)
        if joint:
            j_sample = 0.5 * (sb[0] + sb[1])
            j_scale = _scale_factor_calc(j_sample[None], sblimit)[0]
        else:
            j_sample = None
            j_scale = None
        if layer == 2:
            scfsi = np.zeros((2, SBLIMIT), np.int64)
            for ch in range(nch):
                scfsi[ch] = _transmission_pattern(scalar[ch], sblimit)
        else:
            scfsi = None

        perm_smr = snr[:, f]
        if nch == 1:
            perm_smr = np.concatenate([perm_smr, perm_smr])

        # joint-stereo mode decision (encode.c:927-955)
        adb = adb_frame
        mode, mode_ext = header_mode, 0
        jsbound = sblimit if layer == 2 else SBLIMIT
        if joint:
            mode = mpeg.MODE_STEREO
            mode_ext = 0
            if layer == 2:
                rq = _bits_for_nonoise_II(perm_smr, scfsi, nch, sblimit,
                                          jsbound, alloc,
                                          cfg.error_protection)
            else:
                rq = _bits_for_nonoise_I(perm_smr, nch, jsbound)
            if rq > adb:
                mode = mpeg.MODE_JOINT
                mode_ext = 4
                while True:
                    mode_ext -= 1
                    jsbound = int(T.JSB_TABLE[layer - 1][mode_ext])
                    if layer == 2:
                        rq = _bits_for_nonoise_II(
                            perm_smr, scfsi, nch, sblimit, jsbound, alloc,
                            cfg.error_protection)
                    else:
                        rq = _bits_for_nonoise_I(perm_smr, nch, jsbound)
                    if not (rq > adb and mode_ext > 0):
                        break

        if layer == 2:
            bit_alloc, adb_left = _a_bit_allocation_II(
                perm_smr, scfsi, adb, nch, sblimit, jsbound, alloc,
                cfg.error_protection)
        else:
            bit_alloc, adb_left = _a_bit_allocation_I(
                perm_smr, adb, nch, jsbound, cfg.error_protection)

        # header (encode.c:419-438)
        bs.put(0xFFF, 12)
        bs.put(cfg.version, 1)
        bs.put(4 - layer, 2)
        bs.put(0 if cfg.error_protection else 1, 1)
        bs.put(cfg.bitrate_index, 4)
        bs.put(cfg.sampling_frequency, 2)
        bs.put(0, 1)                    # padding (never fires)
        bs.put(cfg.extension, 1)
        bs.put(mode, 2)
        bs.put(mode_ext, 2)
        bs.put(int(cfg.copyright), 1)
        bs.put(int(cfg.original), 1)
        bs.put(cfg.emphasis, 2)
        if cfg.error_protection:
            crc = _crc_calc(cfg, 0, mode, mode_ext, bit_alloc, scfsi,
                            nch, sblimit, jsbound, alloc, layer)
            bs.put(crc, 16)

        if layer == 1:
            # bit alloc (encode.c:1335-1347)
            for sb in range(SBLIMIT):
                for ch in range(nch if sb < jsbound else 1):
                    bs.put(int(bit_alloc[ch][sb]), 4)
            # scale factors (encode.c:695-707)
            for sb in range(SBLIMIT):
                for ch in range(nch):
                    if bit_alloc[ch][sb]:
                        bs.put(int(scalar[ch][0][sb]), 6)
            # samples (encode.c:1381-1397)
            sbband = np.zeros((2, SCALE_BLOCK, SBLIMIT), np.int64)
            for j in range(SCALE_BLOCK):
                for sb in range(SBLIMIT):
                    for ch in range(nch if sb < jsbound else 1):
                        n = int(bit_alloc[ch][sb])
                        if n:
                            if nch == 2 and sb >= jsbound:
                                d = (j_sample[0][j][sb]
                                     / mpeg.MULTIPLE[j_scale[0][sb]])
                            else:
                                d = (sb_all[ch, f, 0, j, sb]
                                     / mpeg.MULTIPLE[scalar[ch][0][sb]])
                            sbband[ch][j][sb] = _quantize_I(d, n)
            for j in range(SCALE_BLOCK):
                for sb in range(SBLIMIT):
                    for ch in range(nch if sb < jsbound else 1):
                        n = int(bit_alloc[ch][sb])
                        if n:
                            bs.put(int(sbband[ch][j][sb]), n + 1)
        else:
            # bit alloc (encode.c:1351-1365)
            for sb in range(sblimit):
                for ch in range(nch if sb < jsbound else 1):
                    bs.put(int(bit_alloc[ch][sb]), int(alloc["nbal"][sb]))
            # scfsi + scale factors (encode.c:711-737)
            for sb in range(sblimit):
                for ch in range(nch):
                    if bit_alloc[ch][sb]:
                        bs.put(int(scfsi[ch][sb]), 2)
            for sb in range(sblimit):
                for ch in range(nch):
                    if bit_alloc[ch][sb]:
                        sf = scfsi[ch][sb]
                        if sf == 0:
                            for t in range(3):
                                bs.put(int(scalar[ch][t][sb]), 6)
                        elif sf in (1, 3):
                            bs.put(int(scalar[ch][0][sb]), 6)
                            bs.put(int(scalar[ch][2][sb]), 6)
                        else:
                            bs.put(int(scalar[ch][0][sb]), 6)
            # quantize (encode.c:1282-1321)
            sbband = np.zeros((2, 3, SCALE_BLOCK, SBLIMIT), np.int64)
            for t in range(3):
                for j in range(SCALE_BLOCK):
                    for sb in range(sblimit):
                        for ch in range(nch if sb < jsbound else 1):
                            ba = int(bit_alloc[ch][sb])
                            if ba:
                                if nch == 2 and sb >= jsbound:
                                    d = (j_sample[t][j][sb]
                                         / mpeg.MULTIPLE[j_scale[t][sb]])
                                else:
                                    d = (sb_all[ch, f, t, j, sb]
                                         / mpeg.MULTIPLE[scalar[ch][t][sb]])
                                sbband[ch][t][j][sb] = _quantize_II(
                                    d, int(alloc["quant"][sb][ba]),
                                    int(alloc["steps"][sb][ba]))
            # sample encoding (encode.c:1401-1431)
            for t in range(3):
                for j in range(0, SCALE_BLOCK, 3):
                    for sb in range(sblimit):
                        for ch in range(nch if sb < jsbound else 1):
                            ba = int(bit_alloc[ch][sb])
                            if ba:
                                nbits = int(alloc["bits"][sb][ba])
                                if alloc["group"][sb][ba] == 3:
                                    for x in range(3):
                                        bs.put(int(sbband[ch][t][j + x][sb]),
                                               nbits)
                                else:
                                    y = int(alloc["steps"][sb][ba])
                                    temp = (sbband[ch][t][j][sb]
                                            + sbband[ch][t][j + 1][sb] * y
                                            + sbband[ch][t][j + 2][sb] * y * y)
                                    bs.put(int(temp), nbits)
        # ancillary zero fill (musicin.c:658,704)
        for _ in range(adb_left):
            bs.put(0, 1)
    # close_bit_stream_w flushes the current (empty) buffer byte as a
    # trailing 0x00 (common.c:968-974, empty_buffer's inclusive bound)
    return bs.bytes() + b"\x00"
