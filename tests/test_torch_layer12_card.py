"""The Layer I/II chain on the card: K5 (``csrc/alloc12.cu``
``alloc12_kernel``, the joint decision and the greedy bit allocation, one
warp a frame), its first design kept as the yardstick
(``alloc12_baseline_kernel``, ``allocate_baseline``) and K6
(``csrc/pack12.cu``, the frame packing with its CRC, one block a frame)
against their plain versions, the card route of ``encode_layer12_fast``
against the host route it replaced (``chip_smoke.l12_host_route``), one
host wait an encode, and a malformed frame that raises.

The module also holds the lane-level model of the first design's walk
(``model_frame``: the warp's argmin as five xor-shuffle rounds over (value,
index) pairs, the winner lane's update, the broadcast) and the cases both
designs run on (``alloc_cases``); tests/test_torch_alloc12_model.py holds
that model, and tests/test_torch_alloc12_keys.py the model of K5's walk
(ordered keys, the two-half ``redux.sync`` argmin, the packed broadcast),
to ``runtime/alloc12`` and the sequential oracles of ``numpy_ref/layer12``
on the CPU.

A CUDA kernel has no CPU mode, so the card tests carry the `cuda` marker
and skip without a card.  This file imports no jax; run it on the card
without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_layer12_card.py
"""
import inspect
import os
import sys

import numpy as np
import pytest
import torch

from mp3tpu_torch import encoder as E
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.ops import alloc12 as A12
from mp3tpu_torch.ops import layer12 as L12
from mp3tpu_torch.ops import pack12 as P12
from mp3tpu_torch.runtime import alloc12 as host
from mp3tpu_torch.runtime.wav import read_wav
from mp3tpu_torch.tables import mpeg

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
LANES = np.arange(32)

# ---------------------------------------------------------------------------
# the model of K5's walk
# ---------------------------------------------------------------------------


def before(av, ai, bv, bi):
    """(av, ai) before (bv, bi) in numpy's argmin, lane by lane: NaN
    first, then the smaller value, then the smaller index."""
    an, bn = np.isnan(av), np.isnan(bv)
    with np.errstate(invalid="ignore"):
        by_value = np.where(av < bv, True, np.where(bv < av, False, ai < bi))
    return np.where(an | bn, np.where(an & bn, ai < bi, an), by_value)


def warp_argmin(v, i):
    """The warp's five xor-shuffle rounds; every lane ends with the same
    (value, index), which is returned."""
    for o in (16, 8, 4, 2, 1):
        ov, oi = v[LANES ^ o], i[LANES ^ o]
        take = before(ov, oi, v, i)
        v, i = np.where(take, ov, v), np.where(take, oi, i)
    assert (i == i[0]).all() and (np.isnan(v).all() or (v == v[0]).all())
    return v[0], int(i[0])


def rung(lad, bound, x):
    """A lane's linear search of its ladder: searchsorted(side="left") on
    an ascending ladder, a NaN sorting last."""
    k = 0
    if bound > 0:
        while k < bound and (lad[k] < x or np.isnan(x)):
            k += 1
    return k


def nonoise(jb, k, scf, cost, sfs6, nbal, layer, nch, sblimit, ep):
    """bits_for_nonoise at jsbound jb: the lanes' terms, then the warp's
    sum (all integer-valued float64)."""
    lanes = np.zeros(32)
    for sb in range(32):
        js = sb >= jb
        both = nch == 2 and js
        k0, k1 = k[0][sb], k[1][sb]
        ke0 = max(k0, k1) if both else k0
        if layer == 1:
            per0 = (ke0 + 1) * 12 + 6 * (nch if js else 1) if ke0 > 0 else 0
            per1 = (k1 + 1) * 12 + 6 if k1 > 0 else 0
            lanes[sb] = per0 + (per1 if nch == 2 and not js else 0)
            if sb == 0:
                lanes[sb] += 32 + 4 * (jb * nch + (32 - jb))
            continue
        sel = 2.0 + (2.0 if both else 0.0)
        sc0 = sfs6[scf[0][sb]] + (sfs6[scf[1][sb]] if both else 0.0)
        sc1 = sfs6[scf[1][sb]] + (sfs6[scf[0][sb]] if both else 0.0)
        per0 = cost[sb, ke0] + sel + sc0 if ke0 > 0 else 0.0
        per1 = cost[sb, k1] + sel + sc1 if k1 > 0 else 0.0
        if sb < sblimit:
            lanes[sb] = per0 + (per1 if nch == 2 and not js else 0.0)
            lanes[sb] += nbal[sb] * (1 if js else nch)
        if sb == 0:
            lanes[sb] += 32 + (16 if ep else 0)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[LANES ^ o]
    return lanes[0]


def model_frame(smr, scf, layer, table, nch, sblimit, adb, error_protection,
                joint, mode):
    """One frame as K5's warp walks it: smr (2, 32) float64, scf (2, 32)
    ints or None.  Returns {"ba": (2, 32), "adb_left", "mode", "mode_ext",
    "jsbound", "steps"}."""
    dtab, itab = A12.kernel_tables(layer, table)
    snr_after = dtab[:512].reshape(32, 16)
    cost = dtab[512:1024].reshape(32, 16)
    ladder = dtab[1024:1536].reshape(32, 16)
    sfs6 = dtab[1536:1540]
    maxba, nbal, bound, jsb = itab[:32], itab[32:64], itab[64:96], itab[96:]
    ep = bool(error_protection)
    scf = np.zeros((2, 32), np.int64) if scf is None else np.asarray(scf)
    smr = np.asarray(smr, np.float64)

    full = 32 if layer == 1 else sblimit
    jsbound, mode_ext = full, 0
    if joint:
        k = [[rung(ladder[sb], bound[sb], smr[ch][sb]) for sb in range(32)]
             for ch in range(2)]
        args = (k, scf, cost, sfs6, nbal, layer, nch, sblimit, ep)
        needs = nonoise(full, *args) > adb
        mode = mpeg.MODE_JOINT if needs else mpeg.MODE_STEREO
        if needs:
            for ext in (3, 2, 1, 0):
                jsbound, mode_ext = int(jsb[ext]), ext
                if not nonoise(jsbound, *args) > adb:
                    break

    js = LANES >= jsbound
    sbl = 32 if layer == 1 else sblimit
    if layer == 1:
        bbal = 4 * (jsbound * nch + (32 - jsbound))
    else:
        bbal = int(sum(nbal[sb] * (1 if js[sb] else nch)
                       for sb in range(sbl)))
    adf = float(adb - bbal - (16 if ep else 0) - 32)
    mnr = -smr.copy()
    sc6 = sfs6[scf] if layer == 2 else np.zeros((2, 32))
    used = np.zeros((2, 32), np.int64)
    ba = np.zeros((2, 32), np.int64)
    ok = np.stack([LANES < sbl, (LANES < sbl) & (nch == 2)])
    bspl = bscf = bsel = 0.0
    steps = 0
    while True:
        cand = np.where((used != 2) & ok, mnr, host.INF)
        # each lane offers the better of its two candidates
        second = before(cand[1], 2 * LANES + 1, cand[0], 2 * LANES)
        v, idx = warp_argmin(np.where(second, cand[1], cand[0]),
                             np.where(second, 2 * LANES + 1, 2 * LANES))
        lim = host.INF
        if layer == 1:
            lim = mnr[0][0] + 1.0
            lim = lim if np.isnan(lim) or lim < host.INF else host.INF
        if not v < lim:
            break
        steps += 1
        psb, pch = idx >> 1, idx & 1
        cur, first = ba[pch][psb], used[pch][psb] == 0
        seli = 0.0
        if layer == 1:
            inc = 24.0 if first else 12.0
            scale = (6.0 if first else 0.0) * (nch if js[psb] else 1)
        else:
            inc = cost[psb, min(cur + 1, 15)] - (0.0 if first
                                                 else cost[psb, cur])
            seli = 2.0 if first else 0.0
            scale = sc6[pch][psb] if first else 0.0
            if nch == 2:
                extra = js[psb] and first
                seli = seli + (2.0 if extra else 0.0)
                scale = scale + (sc6[1 - pch][psb] if extra else 0.0)
        fits = adf >= bspl + bscf + bsel + seli + scale + inc
        if fits:
            ba[pch][psb] += 1
            used[pch][psb] = 1
            mnr[pch][psb] = -smr[pch][psb] + snr_after[psb, ba[pch][psb]]
            if ba[pch][psb] >= maxba[psb]:
                used[pch][psb] = 2
            bspl, bscf, bsel = bspl + inc, bscf + scale, bsel + seli
        else:
            used[pch][psb] = 2
        if nch == 2 and js[psb]:
            o = 1 - pch
            ba[o][psb], used[o][psb] = ba[pch][psb], used[pch][psb]
            mnr[o][psb] = -smr[o][psb] + snr_after[psb, ba[o][psb]]
    if layer == 2:
        ba[:, sblimit:] = 0
    return dict(ba=ba, adb_left=int(adf - bspl - bscf - bsel), mode=mode,
                mode_ext=mode_ext, jsbound=jsbound, steps=steps)


def model_alloc(smr, scf, **kw):
    """``model_frame`` over (F, 2, 32) frames: numpy arrays of every
    output, int32 as K5 writes them."""
    frames = [model_frame(smr[f], None if scf is None else scf[f], **kw)
              for f in range(smr.shape[0])]
    return {k: np.array([fr[k] for fr in frames], np.int32)
            for k in A12.OUTPUTS + ("steps",)}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

#: (layer, rate, kbps, mode): the five Layer II tables (0: 48 kHz 64 kbps
#: a channel; 1: 44.1 kHz 96; 2: 44.1 kHz 32; 3: 32 kHz 32; 4: LSF) and
#: Layer I at MPEG-1 and LSF rates, stereo, joint and mono
CONFIGS = [
    (2, 48000, 128, mpeg.MODE_STEREO), (2, 48000, 64, mpeg.MODE_MONO),
    (2, 44100, 192, mpeg.MODE_JOINT), (2, 44100, 96, mpeg.MODE_MONO),
    (2, 44100, 64, mpeg.MODE_JOINT), (2, 32000, 64, mpeg.MODE_STEREO),
    (2, 24000, 96, mpeg.MODE_JOINT), (2, 22050, 64, mpeg.MODE_MONO),
    (1, 44100, 384, mpeg.MODE_JOINT), (1, 32000, 192, mpeg.MODE_MONO),
    (1, 24000, 128, mpeg.MODE_STEREO),
]


def config_kw(layer, rate, kbps, mode, crc):
    """``allocate``'s keyword arguments for one configuration."""
    cfg = EncoderConfig(layer=layer, mode=mode, bitrate_kbps=kbps,
                        sample_rate_hz=rate, error_protection=crc)
    cfg.finalize()
    P = E._Layer12Plan(cfg, 1)
    return dict(layer=layer, table=P.table, nch=P.nch, sblimit=P.sblimit,
                adb=P.adb, error_protection=crc, joint=P.joint,
                mode=cfg.mode)


def silent_smr(layer, rate):
    """The SMR the analysis gives four frames of silence: (4, 32)."""
    spf = 384 if layer == 1 else 1152
    z = torch.zeros((1, 4 * spf))
    return L12.analyze_frames(z, z, layer, 32, 1, 4, float(rate))["snr"][0] \
        .to(torch.float64).numpy()


def edge_rows(rng, layer, rate, nch):
    """Forced rows: ties at 0.5 dB, +inf and -inf lanes, NaN lanes (first
    and later), a NaN at [0][0] (Layer I's limit), Layer I's limit biting
    (a loud subband 0), silent frames, every lane -inf and +inf."""
    rows = []
    tie = np.round(rng.uniform(-10, 40, (2, 32)) * 2) / 2
    tie[:, 10:14] = 12.5
    rows.append(tie)
    r = np.round(rng.uniform(-10, 40, (2, 32)) * 2) / 2
    r[0, 3], r[1, 7], r[0, 20] = np.inf, -np.inf, -np.inf
    rows.append(r)
    r = np.round(rng.uniform(-10, 40, (2, 32)) * 2) / 2
    r[:, 5] = np.nan
    rows.append(r)
    r = np.round(rng.uniform(-10, 40, (2, 32)) * 2) / 2
    r[1, 30] = np.nan
    rows.append(r)
    r = np.round(rng.uniform(-10, 40, (2, 32)) * 2) / 2
    r[0, 0] = np.nan
    rows.append(r)
    r = np.round(rng.uniform(0, 60, (2, 32)) * 2) / 2
    r[0, 0] = -30.0
    rows.append(r)
    rows += [np.stack([s, s]) for s in silent_smr(layer, rate)[:2]]
    rows += [np.full((2, 32), -np.inf), np.full((2, 32), np.inf)]
    rows = np.stack(rows)
    if nch == 1:
        rows[:, 1] = rows[:, 0]
    return rows


def alloc_cases(frames=6):
    """[(label, smr (F, 2, 32) float64, scf (F, 2, 32) int32 or None,
    kw)]: every configuration with the CRC off and on, `frames` random
    frames quantized to 0.5 dB (ties) and the edge rows; then a frame at
    a large budget that takes every subband to its top allocation."""
    cases = []
    for n, (layer, rate, kbps, mode) in enumerate(CONFIGS):
        for crc in (False, True):
            kw = config_kw(layer, rate, kbps, mode, crc)
            rng = np.random.RandomState(100 * n + crc)
            smr = np.round(rng.uniform(-20, 60, (frames, 2, 32)) * 2) / 2
            if kw["nch"] == 1:
                smr[:, 1] = smr[:, 0]
            smr = np.concatenate([smr, edge_rows(rng, layer, rate,
                                                 kw["nch"])])
            scf = (rng.randint(0, 4, smr.shape).astype(np.int32)
                   if layer == 2 else None)
            if scf is not None and kw["nch"] == 1:
                scf[:, 1] = scf[:, 0]
            cases.append((f"L{layer} {rate} Hz {kbps} kbps mode {mode}"
                          f"{' crc' if crc else ''}", smr, scf, kw))
    for layer, rate, kbps, mode in ((2, 48000, 384, mpeg.MODE_JOINT),
                                    (1, 44100, 448, mpeg.MODE_STEREO)):
        kw = dict(config_kw(layer, rate, kbps, mode, True), adb=10 ** 6)
        smr = np.full((2, 2, 32), 200.0)
        smr[1] = np.linspace(-5, 90, 64).reshape(2, 32)
        scf = np.full(smr.shape, 1, np.int32) if layer == 2 else None
        cases.append((f"L{layer} every subband to its top", smr, scf, kw))
    return cases


def lockstep_rounds(smr, scf, kw, jsbound):
    """The rounds of ``greedy_allocation``'s lockstep loop on these frames
    (its argmin line's executions, counted by a line tracer)."""
    fn = host.greedy_allocation
    lines, first = inspect.getsourcelines(fn)
    target = first + next(i for i, ln in enumerate(lines)
                          if "flat.argmin(axis=1)" in ln)
    count = 0

    def tracer(frame, event, arg):
        nonlocal count
        if frame.f_code is not fn.__code__:
            return None
        if event == "line" and frame.f_lineno == target:
            count += 1
        return tracer

    sys.settrace(tracer)
    try:
        fn(smr, None if scf is None else scf.astype(np.int64),
           np.full(smr.shape[0], kw["adb"]), jsbound, kw["layer"],
           kw["table"], kw["nch"], kw["error_protection"])
    finally:
        sys.settrace(None)
    return count


def plain_of(smr, scf, kw, device="cpu"):
    """K5's plain version on the case's rows (numpy outputs)."""
    got = A12.allocate_plain(
        torch.as_tensor(smr, device=device),
        None if scf is None else torch.as_tensor(scf, device=device), **kw)
    return {k: got[k].numpy() for k in A12.OUTPUTS}


# ---------------------------------------------------------------------------
# card tests
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 and K6 have no CPU mode")
    return torch.device("cuda")


FIXTURES = [
    ("l2_sine_st_192", 2, mpeg.MODE_STEREO, 192, False),
    ("l2_noise_j_128", 2, mpeg.MODE_JOINT, 128, False),
    ("l2_sweep_mono_96", 2, mpeg.MODE_MONO, 96, False),
    ("l2_trans_st_256_48k", 2, mpeg.MODE_STEREO, 256, False),
    ("l1_sine_st_384", 1, mpeg.MODE_STEREO, 384, False),
    ("l1_sweep_j_256", 1, mpeg.MODE_JOINT, 256, False),
    ("l2_noise_st_192_crc", 2, mpeg.MODE_STEREO, 192, True),
    ("l2_noise_j_128", 2, mpeg.MODE_JOINT, 128, True),
    ("l1_noise_st_448_48k_crc", 1, mpeg.MODE_STEREO, 448, True),
]


def fixture(name, layer, mode, kbps, crc):
    """(pcm, cfg) of a golden fixture (mono fixtures: channel 0)."""
    pcm, rate = read_wav(os.path.join(GOLDEN, f"{name}.wav"))
    if mode == mpeg.MODE_MONO and pcm.ndim == 2:
        pcm = pcm[:, :1]
    return pcm, EncoderConfig(layer=layer, mode=mode, bitrate_kbps=kbps,
                              sample_rate_hz=rate, error_protection=crc)


def design_equals_plain_and_model(allocate, card, model):
    """`allocate` (a design's wrapper) on the card == the plain version on
    every output and == `model`'s steps, on every ``alloc_cases()`` case
    (the forced rows: ties, +-inf, NaN, silent frames, every subband to
    its top, Layer I's limit)."""
    for label, smr, scf, kw in alloc_cases():
        got = allocate(
            torch.as_tensor(smr, device=card),
            None if scf is None else torch.as_tensor(scf, device=card), **kw)
        want = plain_of(smr, scf, kw)
        steps = model(smr, scf, **kw)["steps"]
        for k in A12.OUTPUTS:
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k],
                                          err_msg=f"{label}: {k}")
        np.testing.assert_array_equal(got["steps"].cpu().numpy(), steps,
                                      err_msg=label)


@pytest.mark.cuda
def test_k5_equals_plain_and_model(card):
    from test_torch_alloc12_keys import model_alloc as keys_model
    before = A12.baseline_launches
    design_equals_plain_and_model(A12.allocate, card, keys_model)
    assert A12.baseline_launches == before


@pytest.mark.cuda
def test_k5_baseline_equals_plain_and_model(card):
    before = A12.launches
    design_equals_plain_and_model(A12.allocate_baseline, card, model_alloc)
    assert A12.launches == before


@pytest.mark.cuda
def test_k5_keeps_its_state_in_registers_and_runs_in_one_wave(card,
                                                              tmp_path):
    """nvcc -Xptxas -v: alloc12_kernel (both layers) with no stack frame
    and no spill, at most 32 registers; the first design beside it; the
    60 s Layer I clip's 6,891 frames in one wave."""
    from mp3tpu_torch.ops import cuda_build
    log = cuda_build.build(A12.SOURCE, str(tmp_path / "liballoc12.so"),
                           A12.NVCC_FLAGS + ["-Xptxas", "-v"], force=True)
    report = A12.kernel_report(log)
    assert set(report) == {"alloc12_kernel<1>", "alloc12_kernel<2>",
                           "alloc12_baseline_kernel"}, log
    for name in ("alloc12_kernel<1>", "alloc12_kernel<2>"):
        r = report[name]
        assert (r["stack"], r["spill_stores"], r["spill_loads"]) == \
            (0, 0, 0), (name, r)
        assert r["registers"] <= 32, (name, r)
    assert A12.waves(6891, 1) == 1
    per_sm, per_block = A12.occupancy(1)
    assert per_sm * per_block * 132 >= 6891


@pytest.mark.cuda
@pytest.mark.parametrize("case", FIXTURES, ids=[c[0] + ("_crc" * c[4])
                                                for c in FIXTURES])
def test_card_route_equals_host_route(card, case):
    pcm, cfg = fixture(*case)
    from chip_smoke import l12_host_route
    out = E.encode_layer12_fast(pcm, cfg, "cuda")
    assert out == l12_host_route(pcm, cfg, "cuda")


@pytest.mark.cuda
def test_k6_equals_plain_on_the_chain_rows(card, monkeypatch):
    """K6 on the card == its plain version on the rows an encode makes (the
    CRC fixture and a joint one), and the bytes == the host route's
    (pack_elements with _crc_calc)."""
    from chip_smoke import l12_host_route
    rows = []
    real = L12.marshal_frames

    def spy(*args):
        out = real(*args)
        rows.append(out)
        return out

    monkeypatch.setattr(L12, "marshal_frames", spy)
    for case in (FIXTURES[6], FIXTURES[7], FIXTURES[8]):
        pcm, cfg = fixture(*case)
        E.encode_layer12_fast(pcm, cfg, "cuda")
        values, lengths, crc = rows[-1]
        P = E._Layer12Plan(cfg, values.shape[0])
        got = P12.pack_frames(values, lengths, P.frame_bytes, crc)
        want = P12.pack_frames_plain(values, lengths, P.frame_bytes, crc)
        assert torch.equal(got.cpu(), want.cpu()), case[0]
        status, frames = P12.split(got.cpu())
        assert status.tolist() == [0, 0]
        assert frames.numpy().tobytes() + b"\x00" == \
            l12_host_route(pcm, cfg, "cuda")


@pytest.mark.cuda
def test_one_wait_an_encode_and_a_window(card):
    from mp3tpu_torch.tools import host_waits
    pcm, cfg = fixture(*FIXTURES[1])
    E.encode_layer12_fast(pcm, cfg, "cuda")                 # warm
    k5, first = A12.launches, A12.baseline_launches
    out, waits = host_waits(lambda: E.encode_layer12_fast(pcm, cfg, "cuda"))
    assert sum(waits.values()) == 1, waits
    assert (A12.launches - k5, A12.baseline_launches - first) == (1, 0)
    pieces = [pcm[s:s + 20000] for s in range(0, len(pcm), 20000)]
    nwin = -(-(-(-len(pcm) // 1152)) // 8)
    streamed, waits = host_waits(lambda: b"".join(E.encode_layer12_stream(
        iter(pieces), cfg, "cuda", window_frames=8)))
    assert streamed == out
    assert sum(waits.values()) == nwin, waits


@pytest.mark.cuda
def test_a_bad_length_raises(card, monkeypatch):
    real = L12.marshal_frames

    def broken(*args):
        values, lengths, crc = real(*args)
        lengths = lengths.clone()
        lengths[1, 3] += 1
        return values, lengths, crc

    monkeypatch.setattr(L12, "marshal_frames", broken)
    pcm, cfg = fixture(*FIXTURES[0])
    with pytest.raises(RuntimeError, match="1 frame"):
        E.encode_layer12_fast(pcm, cfg, "cuda")


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    smr = torch.zeros((4, 2, 32), dtype=torch.float32, device=card)
    kw = config_kw(2, 44100, 192, mpeg.MODE_STEREO, False)
    with pytest.raises(TypeError):
        A12.allocate(smr, torch.zeros((4, 2, 32), dtype=torch.int32,
                                      device=card), **kw)
    with pytest.raises(ValueError):
        A12.allocate(smr.double(), None, **kw)
    v = torch.zeros((3, 10), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        P12.pack_frames(v, v.long(), 6)
    with pytest.raises(ValueError):
        P12.pack_frames(v, v, 6, crc=(2, 11))
