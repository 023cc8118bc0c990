"""Layer III main_data emission and bit packing on the device (port of
mp3tpu/ops/jaxbits.py).

Scalefactors and Huffman codewords become (value, length) elements --
36 scalefactor slots + 576 pair slots + 144 quad slots per granule --
and are packed MSB-first into per-granule word rows, then compacted
into one flat buffer.  Semantics replicate l3bitstream.c:516-716 and
:195-254; the byte-exact oracle is mp3tpu/numpy_ref/bitstream.py.

Codes come from table gathers, and the packer adds each element's
aligned contributions into its (at most two) words with
``scatter_add_`` -- contributions to one word occupy disjoint bits, so
the sum equals the OR.  All bit work is int64; words are converted to
uint32 only at the numpy boundary.
"""
import numpy as np
import torch

from ..runtime.profiling import span
from ..tables import mpeg
from ..tables.huffman import HUFF

PAYLOAD_WORDS = 128   # 4096 bits >= max part2_3_length (12-bit field)

_MASK32 = 0xFFFFFFFF

# LSF partition of each long sfb (21) and of each short (sfb, window)
# slot (36), for table_number 0 and 2 (jaxbits._P_LONG_T0 ... _P_SHORT_T2)
_NR = mpeg.NR_OF_SFB_BLOCK
P_LONG_T0 = np.repeat(np.arange(4), _NR[0][0])
P_LONG_T2 = np.repeat(np.arange(4), _NR[2][0])
P_SHORT_T0 = np.repeat(np.arange(4), _NR[0][1] // 3)
P_SHORT_T2 = np.repeat(np.arange(4), _NR[2][1] // 3)


def numpy_tables():
    """Emission lookup tables (numpy, int64)."""
    return dict(
        pair_code=HUFF.codes.reshape(34 * 256).astype(np.int64),
        pair_hlen=HUFF.hlen.reshape(34 * 256).astype(np.int64),
        linbits=HUFF.linbits.astype(np.int64),
        c1_code=HUFF.codes[32:34, 0, :16].reshape(32).astype(np.int64),
        c1_hlen=HUFF.hlen[32:34, 0, :16].reshape(32).astype(np.int64),
        slen1=mpeg.SLEN1_TAB.astype(np.int64),
        slen2=mpeg.SLEN2_TAB.astype(np.int64),
        lsf_part_long=np.stack([P_LONG_T0, P_LONG_T2]).astype(np.int64),
        lsf_part_short=np.stack([np.repeat(P_SHORT_T0, 3),
                                 np.repeat(P_SHORT_T2, 3)]).astype(np.int64))


def device_tables(device):
    return {k: torch.as_tensor(v, device=device)
            for k, v in numpy_tables().items()}


def scalefac_elements(sf_l, sf_s, compress, is_short, BT, skip_mask=None):
    """MPEG-1 scalefactor (value, length) elements, 36 slots per granule
    (l3bitstream.c:221-254).  skip_mask (G, 21): long sfbs not
    transmitted (scfsi)."""
    G = sf_l.shape[0]
    dev = sf_l.device
    compress = compress.to(torch.int64)
    slen1 = BT["slen1"][compress][:, None]
    slen2 = BT["slen2"][compress][:, None]
    j = torch.arange(36, device=dev)[None, :]
    len_s = torch.where(j // 3 < 6, slen1, slen2)
    val_l = torch.cat([sf_l.to(torch.int64),
                       torch.zeros((G, 15), dtype=torch.int64, device=dev)],
                      dim=1)
    len_l = torch.where(j < 11, slen1, torch.where(j < 21, slen2, 0))
    if skip_mask is not None:
        skip36 = torch.cat([skip_mask, torch.zeros((G, 15), dtype=torch.bool,
                                                   device=dev)], dim=1)
        len_l = torch.where(skip36, 0, len_l)
    values = torch.where(is_short[:, None], sf_s.reshape(G, 36)
                         .to(torch.int64), val_l)
    lengths = torch.where(is_short[:, None], len_s, len_l)
    return values, lengths


def scalefac_elements_lsf(sf_l, sf_s, compress, is_short, BT):
    """MPEG-2 LSF scalefactor elements, 36 slots per granule.  The four
    slen values and the partition come from the 9-bit scalefac_compress
    as a decoder derives them (IS 13818-3 2.4.3.2); compress >= 500
    implies table_number 2 (preflag).  Long: sfb 0..20; short: (sfb,
    window) slots."""
    G = sf_l.shape[0]
    dev = sf_l.device
    sc = compress.to(torch.int64)
    pre = sc >= 500
    s2 = (sc - 500).clamp(min=0)
    z = torch.zeros_like(s2)
    slen = torch.where(
        pre[:, None], torch.stack([s2 // 3, s2 % 3, z, z], dim=1),
        torch.stack([(sc >> 4) // 5, (sc >> 4) % 5, (sc & 15) >> 2, sc & 3],
                    dim=1))                                   # (G, 4)
    p = pre.to(torch.int64)
    len_l = torch.cat([torch.gather(slen, 1, BT["lsf_part_long"][p]),
                       torch.zeros((G, 15), dtype=torch.int64, device=dev)],
                      dim=1)
    len_s = torch.gather(slen, 1, BT["lsf_part_short"][p])
    val_l = torch.cat([sf_l.to(torch.int64),
                       torch.zeros((G, 15), dtype=torch.int64, device=dev)],
                      dim=1)
    values = torch.where(is_short[:, None], sf_s.reshape(G, 36)
                         .to(torch.int64), val_l)
    lengths = torch.where(is_short[:, None], len_s, len_l)
    return values, lengths


def _regions(G, a1, a2, big_values, is_short, r0_pairs_short, dev):
    """Per-pair region (G, 288) and validity."""
    p = torch.arange(288, device=dev)[None, :]
    pos2 = 2 * p
    long_r = torch.where(pos2 < a1[:, None], 0,
                         torch.where(pos2 < a2[:, None], 1, 2))
    region = torch.where(is_short[:, None], (p >= r0_pairs_short)
                         .to(torch.int64), long_r)
    valid = is_short[:, None] | (pos2 < 2 * big_values[:, None])
    return region, valid


def pair_elements(ix_signed, a1, a2, big_values, table_select, is_short,
                  ST, BT):
    """Huffman elements of the 288 big-value pairs: per pair a code
    element (code + sign bits for tables <= 15) and an ext element (ESC
    linbits + signs, tables > 15), interleaved in stream order.
    Returns (values (G, 576) int64, lengths (G, 576) int64)."""
    G = ix_signed.shape[0]
    dev = ix_signed.device
    ixp = torch.where(is_short[:, None], ix_signed[:, ST["perm_short"]],
                      ix_signed).to(torch.int64)
    pairs = ixp.reshape(G, 288, 2)
    xs, ys = pairs[..., 0], pairs[..., 1]
    sgx = (xs < 0).to(torch.int64)
    sgy = (ys < 0).to(torch.int64)
    x, y = xs.abs(), ys.abs()

    region, valid = _regions(G, a1.to(torch.int64), a2.to(torch.int64),
                             big_values.to(torch.int64), is_short,
                             ST["r0_pairs_short"], dev)
    t = torch.gather(table_select.to(torch.int64).clamp(0, 33), 1, region)
    valid = valid & (t > 0)

    lut = t * 256 + x.clamp(max=15) * 16 + y.clamp(max=15)
    code = BT["pair_code"][lut]
    cbits = BT["pair_hlen"][lut]
    linbits = BT["linbits"][t]
    esc = t > 15

    # tables <= 15: sign bits appended to the code (l3bitstream.c:860)
    nx = x != 0
    ny = y != 0
    csmall = torch.where(nx, (code << 1) | sgx, code)
    csmall = torch.where(ny, (csmall << 1) | sgy, csmall)
    lsmall = cbits + nx + ny

    # ESC ext field (l3bitstream.c:826-850): linbits(x-15), sign x,
    # linbits(y-15), sign y -- each present per its own condition
    bx = x > 14
    by = y > 14
    ext = torch.where(bx, (x - 15).clamp(min=0), 0)
    xb = torch.where(bx, linbits, 0)
    ext = torch.where(nx, (ext << 1) | sgx, ext)
    xb = xb + nx
    ext = torch.where(by, (ext << linbits) | (y - 15).clamp(min=0), ext)
    xb = xb + torch.where(by, linbits, 0)
    ext = torch.where(ny, (ext << 1) | sgy, ext)
    xb = xb + ny

    code_val = torch.where(esc, code, csmall)
    code_len = torch.where(valid, torch.where(esc, cbits, lsmall), 0)
    ext_len = torch.where(valid & esc, xb, 0)
    values = torch.stack([code_val, ext], dim=2).reshape(G, 576)
    lengths = torch.stack([code_len, ext_len], dim=2).reshape(G, 576)
    return values, lengths


def count1_elements(ix_signed, big_values, count1, c1ts, BT):
    """count1-region quads (l3bitstream.c:728-767): code plus a sign bit
    after each nonzero component, one element per quad (<= 10 bits).
    The quad index is the conformant (v<<3)|(w<<2)|(x<<1)|y; the region
    starts at 2*big_values, realigned to 4 like the bit count."""
    G = ix_signed.shape[0]
    dev = ix_signed.device
    start = 2 * big_values.to(torch.int64)
    mis = (start % 4) != 0
    ixs = torch.where(mis[:, None], torch.roll(ix_signed, -2, dims=1),
                      ix_signed).to(torch.int64)
    start = torch.where(mis, start - 2, start)
    q = ixs.reshape(G, 144, 4)
    a = q.abs().clamp(max=1)
    sg = (q < 0).to(torch.int64)
    p = 8 * a[..., 0] + 4 * a[..., 1] + 2 * a[..., 2] + a[..., 3]
    lut = c1ts.to(torch.int64)[:, None] * 16 + p
    code = BT["c1_code"][lut]
    hl = BT["c1_hlen"][lut]
    for k in range(4):
        nz = a[..., k] != 0
        code = torch.where(nz, (code << 1) | sg[..., k], code)
        hl = hl + nz
    q4 = 4 * torch.arange(144, device=dev)[None, :]
    valid = (q4 >= start[:, None]) \
        & (q4 < (start + 4 * count1.to(torch.int64))[:, None])
    return code, torch.where(valid, hl, 0)


def granule_elements(state, ix_signed, is_short, ST, BT, skip_mask=None):
    """The whole main_data element stream of a granule batch: 36 + 576 +
    144 = 756 elements.  state: the outer_loop output dict."""
    if ST["lsf"]:
        sv, sl = scalefac_elements_lsf(state["sf_l"], state["sf_s"],
                                       state["compress"], is_short, BT)
    else:
        sv, sl = scalefac_elements(state["sf_l"], state["sf_s"],
                                   state["compress"], is_short, BT,
                                   skip_mask=skip_mask)
    pv, pl = pair_elements(ix_signed, state["a1"], state["a2"],
                           state["big_values"], state["table_select"],
                           is_short, ST, BT)
    qv, ql = count1_elements(ix_signed, state["big_values"],
                             state["count1"], state["count1table_select"],
                             BT)
    return (torch.cat([sv, pv, qv], dim=1), torch.cat([sl, pl, ql], dim=1))


def pack_elements(values, lengths, w_cap=PAYLOAD_WORDS):
    """Bit-pack (G, E) MSB-first elements (lengths <= 32) -> ((G, w_cap)
    int64 words holding uint32 values, (G,) total bits).  Bits past
    w_cap words are dropped."""
    G, E = values.shape
    lengths = lengths.to(torch.int64)
    vmask = (torch.ones_like(lengths) << lengths) - 1
    v_msb = torch.where(lengths > 0,
                        (values.to(torch.int64) & vmask) << (32 - lengths), 0)
    end = torch.cumsum(lengths, dim=1)
    off = end - lengths
    nbits = end[:, -1]
    w0 = off >> 5
    r = off & 31
    c0 = v_msb >> r                                       # into word w0
    c1 = torch.where(r > 0, (v_msb << (32 - r)) & _MASK32, 0)  # word w0+1
    words = torch.zeros((G, w_cap + 1), dtype=torch.int64,
                        device=values.device)
    # the extra column collects everything past the cap
    words.scatter_add_(1, w0.clamp(max=w_cap), c0)
    words.scatter_add_(1, (w0 + 1).clamp(max=w_cap), c1)
    return words[:, :w_cap], nbits


@span("granule_payload")
def granule_payload(state, ix_signed, is_short, ST, BT, w_cap=PAYLOAD_WORDS,
                    skip_mask=None):
    """Emit + pack a granule batch's main_data: (payload (G, w_cap),
    nbits (G,)); nbits equals part2_3_length by construction."""
    values, lengths = granule_elements(state, ix_signed, is_short, ST, BT,
                                       skip_mask=skip_mask)
    return pack_elements(values, lengths, w_cap)


@span("compact_payload")
def compact_payload(payload, nbits, total_cap):
    """Row-compact a (N, W) payload into one flat (total_cap,) buffer:
    lane g's ceil(nbits[g]/32) words land at the exclusive cumsum of the
    word counts, lane order kept.  The host re-derives the offsets from
    part2_3_length."""
    N, W = payload.shape
    dev = payload.device
    wlen = (nbits.to(torch.int64) + 31) >> 5
    off = torch.cumsum(wlen, dim=0) - wlen
    # lane of each output word: one mark per lane at its start offset
    # (empty lanes share the next lane's offset; the last mark wins)
    marks = torch.zeros(total_cap + 1, dtype=torch.int64, device=dev)
    marks.scatter_add_(0, off.clamp(max=total_cap), torch.ones_like(off))
    lane = (torch.cumsum(marks[:total_cap], dim=0) - 1).clamp(0, N - 1)
    j = torch.arange(total_cap, device=dev) - off[lane]
    ok = (j >= 0) & (j < W)
    idx = lane * W + torch.where(ok, j, 0)
    return torch.where(ok, payload.reshape(-1)[idx], 0)


def payload_cap_words(n_frames, bits_per_frame, sideinfo_len, resv_max,
                      n_lanes):
    """Static flat-buffer size: the reservoir bounds sum(part2_3_length)
    by frames*(frame bits - side info) + resv_max; per-lane word
    alignment adds at most one word per lane."""
    total_bits = n_frames * (bits_per_frame - sideinfo_len) + resv_max
    return int(total_bits // 32 + n_lanes + 16)


def to_uint32(words):
    """int64 words holding uint32 values -> numpy uint32 (host copy)."""
    return words.to(torch.int32).cpu().numpy().view(np.uint32)
