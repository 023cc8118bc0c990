"""Layer I/II decoder (NumPy), for quality metrics in tests.

Parses headers/bit allocation/scfsi/scale factors/samples and
reconstructs PCM through the ISO synthesis filterbank.  The sample
requantization inverts the encoder's a*x+b law exactly (encoder
midpoint reconstruction), which is equivalent to the ISO C/D table
formula to float precision.
"""
import numpy as np

from ..tables import layer12 as T
from ..tables import mpeg
from ..tables.dsp import ENWINDOW


class _BitReader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def get(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3]
                             >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def _dequant(code, qnt_a, qnt_b, nbits):
    """Invert _apply_quant: midpoint reconstruction."""
    n = nbits
    sig = (code >> n) & 1
    frac = (code & ((1 << n) - 1)) / float(1 << n)
    d2 = frac + 0.5 / (1 << n)
    d2 = d2 if sig else d2 - 1.0
    return (d2 - qnt_b) / qnt_a


def decode(data):
    """Decode a Layer I/II stream -> (pcm float array (N, nch), rate)."""
    br = _BitReader(data)
    out = []
    nch_out = None
    # synthesis state per channel
    v_state = None
    while br.pos + 32 <= len(data) * 8:
        sync = br.get(12)
        if sync != 0xFFF:
            break
        version = br.get(1)
        layer = 4 - br.get(2)
        no_prot = br.get(1)
        bitrate_index = br.get(4)
        sampling_frequency = br.get(2)
        br.get(1)  # padding
        br.get(1)  # extension
        mode = br.get(2)
        mode_ext = br.get(2)
        br.get(1)
        br.get(1)
        br.get(2)
        if not no_prot:
            br.get(16)
        nch = 1 if mode == mpeg.MODE_MONO else 2
        if nch_out is None:
            nch_out = nch
            v_state = [np.zeros(1024) for _ in range(nch)]
        sfreq_khz = mpeg.S_FREQ_KHZ[version][sampling_frequency]
        kbps = int(mpeg.BITRATE_KBPS[version][layer - 1][bitrate_index])
        if layer == 2:
            table, sblimit = T.pick_table(version, 2, bitrate_index,
                                          sampling_frequency, nch, kbps,
                                          float(sfreq_khz))
            alloc = T.ALLOC[table]
        else:
            table, sblimit, alloc = None, 32, None
        jsbound = (int(T.JSB_TABLE[layer - 1][mode_ext])
                   if mode == mpeg.MODE_JOINT else sblimit)
        ngr = 1 if layer == 1 else 3

        ba = np.zeros((2, 32), np.int64)
        for sb in range(sblimit):
            w = 4 if layer == 1 else int(alloc["nbal"][sb])
            for ch in range(nch if sb < jsbound else 1):
                ba[ch][sb] = br.get(w)
            if nch == 2 and sb >= jsbound:
                ba[1][sb] = ba[0][sb]
        scfsi = np.zeros((2, 32), np.int64)
        if layer == 2:
            for sb in range(sblimit):
                for ch in range(nch):
                    if ba[ch][sb]:
                        scfsi[ch][sb] = br.get(2)
        sf = np.zeros((2, 32, 3), np.int64)
        for sb in range(sblimit):
            for ch in range(nch):
                if ba[ch][sb]:
                    if layer == 1:
                        sf[ch][sb][:] = br.get(6)
                    else:
                        s = scfsi[ch][sb]
                        if s == 0:
                            sf[ch][sb] = [br.get(6), br.get(6), br.get(6)]
                        elif s == 1:
                            a, b = br.get(6), br.get(6)
                            sf[ch][sb] = [a, a, b]
                        elif s == 3:
                            a, b = br.get(6), br.get(6)
                            sf[ch][sb] = [a, b, b]
                        else:
                            sf[ch][sb][:] = br.get(6)

        spf = 384 if layer == 1 else 1152
        sbs = np.zeros((2, ngr, 12, 32))
        if layer == 1:
            for j in range(12):
                for sb in range(32):
                    for ch in range(nch if sb < jsbound else 1):
                        n = int(ba[ch][sb])
                        if n:
                            code = br.get(n + 1)
                            d = _dequant(code, T.QUANT_A_L1[n - 1],
                                         T.QUANT_B_L1[n - 1], n)
                            sbs[ch][0][j][sb] = d * mpeg.MULTIPLE[sf[ch][sb][0]]
                            if nch == 2 and sb >= jsbound:
                                sbs[1][0][j][sb] = sbs[0][0][j][sb]
        else:
            for t in range(3):
                for j in range(0, 12, 3):
                    for sb in range(sblimit):
                        for ch in range(nch if sb < jsbound else 1):
                            a_ = int(ba[ch][sb])
                            if not a_:
                                continue
                            stp = int(alloc["steps"][sb][a_])
                            bits = int(alloc["bits"][sb][a_])
                            qnt = int(alloc["quant"][sb][a_])
                            n = 0
                            while (1 << n) < stp:
                                n += 1
                            n -= 1
                            if alloc["group"][sb][a_] == 3:
                                codes = [br.get(bits) for _ in range(3)]
                            else:
                                v = br.get(bits)
                                codes = [v % stp, (v // stp) % stp,
                                         (v // (stp * stp)) % stp]
                            for x in range(3):
                                d = _dequant(codes[x], T.QUANT_A[qnt],
                                             T.QUANT_B[qnt], n)
                                val = d * mpeg.MULTIPLE[sf[ch][sb][t]]
                                sbs[ch][t][j + x][sb] = val
                                if nch == 2 and sb >= jsbound:
                                    sbs[1][t][j + x][sb] = val
        # reconstruct PCM through the synthesis filterbank
        pcm = np.zeros((spf, nch))
        for ch in range(nch):
            flat = sbs[ch].reshape(ngr * 12, 32)
            for s in range(ngr * 12):
                pcm[s * 32:(s + 1) * 32, ch] = _synth(flat[s], v_state[ch])
        out.append(pcm)
        # CBR without padding: frames sit on a fixed byte grid
        bits_per_slot = 32 if layer == 1 else 8
        whole_spf = int((spf / float(sfreq_khz)) * (kbps / bits_per_slot))
        br.pos = len(out) * whole_spf * bits_per_slot
    rate = float(sfreq_khz) * 1000.0
    return (np.concatenate(out) if out else np.zeros((0, 1))), rate


_SYNTH_N = None


def _synth_matrix():
    global _SYNTH_N
    if _SYNTH_N is None:
        i = np.arange(64)[:, None]
        k = np.arange(32)[None, :]
        _SYNTH_N = np.cos((16 + i) * (2 * k + 1) * np.pi / 64.0)
    return _SYNTH_N


def _synth(s, v):
    """ISO 11172-3 2.4.3.2 synthesis filterbank, one 32-sample slot.
    v: (1024,) rolling state (mutated).  Returns 32 PCM samples."""
    N = _synth_matrix()
    v[64:] = v[:-64].copy()
    v[:64] = N @ s
    # u: interleave halves of alternate 128-blocks
    u = np.empty(512)
    blk = v.reshape(16, 64)
    u.reshape(8, 64)[:, :32] = blk[0::2, :32]
    u.reshape(8, 64)[:, 32:] = blk[1::2, 32:]
    w = u * (32.0 * ENWINDOW)
    return w.reshape(16, 32).sum(axis=0)
