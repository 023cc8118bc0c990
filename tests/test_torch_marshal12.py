"""The back half of the port's Layer I/II chain on the CPU, against the
JAX package: ``ops/layer12.marshal_frames`` (the element rows, frame by
frame) equals ``mp3tpu.encoder._marshal_layer12`` element for element
(the CRC field as 16 zero bits, which K6 fills; the ancillary slots
padded to a fixed count with slots of length 0);
K6's plain version (``ops/pack12.pack_frames_plain``) equals the native
packer ``pack_elements`` with ``numpy_ref/layer12._crc_calc`` byte for
byte on every frame; and, given the JAX package's own analysis outputs,
the port's back half (K5's plain version, the quantizers,
``marshal_frames``, K6's plain version) gives the JAX package's
``encode_layer12_fast`` bytes exactly -- the six fixtures, the CRC
fixtures and MPEG-2 LSF.  The card chain (``encode_layer12_fast``)
equals the host route it replaced (``chip_smoke.l12_host_route``) on
the CPU, and a malformed frame raises after the one download.
"""
import numpy as np
import pytest
import torch

from mp3tpu import encoder as jencoder
from mp3tpu.ops import jaxlayer12 as J
from mp3tpu_torch import encoder as E
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.numpy_ref.layer12 import _crc_calc
from mp3tpu_torch.ops import layer12 as L12
from mp3tpu_torch.ops import pack12 as P12
from mp3tpu_torch.runtime.bitstream import pack_elements
from mp3tpu_torch.tables import mpeg
from chip_smoke import l12_host_route
from test_torch_layer12_card import FIXTURES, fixture

torch.set_num_threads(1)

#: the card test's fixtures (the six, the CRC fixtures, a joint one with the
#: CRC on) and MPEG-2 LSF Layer II and Layer I, psy model 1 on one
CASES = FIXTURES + [("lsf_l2", 2, mpeg.MODE_STEREO, 96, True),
                    ("lsf_l1", 1, mpeg.MODE_MONO, 96, False),
                    ("psy1_l2", 2, mpeg.MODE_JOINT, 128, False)]
IDS = [f"{c[0]}{'_crc' * c[4]}" for c in CASES]


def case_input(name, layer, mode, kbps, crc):
    """(pcm, cfg): a golden fixture, or for the LSF cases 0.5 s of a tone
    with noise at 24 / 22.05 kHz, or psy model 1 on a fixture."""
    if name.startswith("lsf"):
        rate = 24000 if layer == 2 else 22050
        t = np.arange(int(0.5 * rate)) / rate
        x = np.clip((0.25 * np.sin(2 * np.pi * 440 * t)
                     + 0.02 * np.random.RandomState(5).randn(len(t)))
                    * 20000, -32768, 32767).astype(np.int16)
        pcm = x if mode == mpeg.MODE_MONO else np.stack(
            [x, (x * 0.5).astype(np.int16)], 1)
        return pcm, EncoderConfig(layer=layer, mode=mode, bitrate_kbps=kbps,
                                  sample_rate_hz=rate, error_protection=crc)
    if name == "psy1_l2":
        pcm, cfg = fixture("l2_noise_j_128", layer, mode, kbps, crc)
        cfg.psy_model = 1
        return pcm, cfg
    return fixture(name, layer, mode, kbps, crc)


def host_args(pcm, cfg, monkeypatch):
    """The arguments ``l12_host_route`` gives ``_marshal_layer12``."""
    captured = []
    real = E._marshal_layer12

    def capture(*args):
        captured.append(args)
        return real(*args)

    monkeypatch.setattr(E, "_marshal_layer12", capture)
    l12_host_route(pcm, cfg, "cpu")
    return captured[0]


def rows_of(args):
    """``marshal_frames`` on ``_marshal_layer12``'s arguments."""
    (cfg, layer, table, sblimit, nch, F, mode, mode_ext, jsbound, ba, scfsi,
     scalar, codes, adb_left) = args
    P = E._Layer12Plan(cfg, F)
    t = torch.as_tensor
    return P, L12.marshal_frames(
        cfg, layer, table, sblimit, nch, t(mode), t(mode_ext), t(jsbound),
        t(ba), None if scfsi is None else t(np.asarray(scfsi)), t(scalar),
        t(codes), t(adb_left), P.adb)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_marshal_frames_equals_jax_marshal(case, monkeypatch):
    args = host_args(*case_input(*case), monkeypatch)
    vr, lr = jencoder._marshal_layer12(*args)
    P, (values, lengths, crc) = rows_of(args)
    F = P.F
    vr, lr = vr.reshape(F, -1), lr.reshape(F, -1)
    E_ref = vr.shape[1]
    anc_ref = -(-int(args[-1].max()) // 32)
    anc = L12.anc_slots(P.adb, P.layer, P.table, P.sblimit, P.nch,
                        args[0].error_protection)
    fixed = E_ref - anc_ref
    assert values.shape == lengths.shape == (F, fixed + anc)
    assert anc >= anc_ref
    got_v = values.numpy().view(np.uint32)
    if args[0].error_protection:
        # the CRC field goes in as 16 zero bits, for K6 to fill
        assert (got_v[:, 1] == 0).all()
        vr = vr.copy()
        vr[:, 1] = 0
    np.testing.assert_array_equal(got_v[:, :E_ref], vr)
    np.testing.assert_array_equal(lengths.numpy()[:, :E_ref], lr)
    assert (lengths.numpy()[:, E_ref:] == 0).all()
    assert (lengths.numpy().sum(axis=1) == 8 * P.frame_bytes).all()
    if args[0].error_protection:
        first, end = crc
        assert first == 2 and lengths[:, 1].eq(16).all()
        assert end == 2 + 32 * P.nch * (2 if P.layer == 2 else 1)
    else:
        assert crc is None


@pytest.mark.parametrize("case", [c for c in CASES if c[4]],
                         ids=[i for c, i in zip(CASES, IDS) if c[4]])
def test_pack_plain_equals_native_pack_and_crc_calc(case, monkeypatch):
    """Every frame's bytes, CRC words included: K6's plain version on
    ``marshal_frames``' rows against ``pack_elements`` of the JAX
    marshalling, and each frame's bits 32-47 against ``_crc_calc``."""
    args = host_args(*case_input(*case), monkeypatch)
    P, (values, lengths, crc) = rows_of(args)
    buf = P12.pack_frames(values, lengths, P.frame_bytes, crc)
    status, frames = P12.split(buf)
    assert status.tolist() == [0, 0]
    want = pack_elements(*jencoder._marshal_layer12(*args))
    got = frames.numpy().tobytes()
    assert len(got) == len(want) == P.F * P.frame_bytes
    (cfg, layer, table, sblimit, nch, F, mode, mode_ext, jsbound, ba, scfsi,
     scalar, codes, adb_left) = args
    from mp3tpu_torch.tables import layer12 as T
    alloc = T.ALLOC[table] if layer == 2 else None
    ba2 = ba if nch == 2 else np.repeat(ba[:, :1], 2, axis=1)
    for f in range(F):
        a, b = f * P.frame_bytes, (f + 1) * P.frame_bytes
        assert got[a:b] == want[a:b], f
        word = _crc_calc(cfg, 0, int(mode[f]), int(mode_ext[f]), ba2[f],
                         None if scfsi is None else
                         np.stack([scfsi[0][f], scfsi[nch - 1][f]]),
                         nch, sblimit, int(jsbound[f]), alloc, layer)
        assert got[a + 4] << 8 | got[a + 5] == word, f


def jax_encode_with_analysis(pcm, cfg, monkeypatch):
    """The JAX package's ``encode_layer12_fast`` bytes and the analysis
    outputs it ran on (numpy)."""
    seen = []
    real = J.analyze_frames

    def capture(*args):
        out = real(*args)
        seen.append({k: np.asarray(v) for k, v in out.items()})
        return out

    monkeypatch.setattr(J, "analyze_frames", capture)
    import mp3tpu.config as jconfig
    jcfg = jconfig.EncoderConfig(
        layer=cfg.layer, mode=cfg.mode, bitrate_kbps=cfg.bitrate_kbps,
        sample_rate_hz=cfg.sample_rate_hz,
        error_protection=cfg.error_protection)
    out = jencoder.encode_layer12_fast(pcm, jcfg)
    return out, seen[0]


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "psy1_l2"],
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[0] != "psy1_l2"])
def test_back_half_on_jax_analysis_gives_jax_bytes(case, monkeypatch):
    pcm, cfg = case_input(*case)
    want, ana = jax_encode_with_analysis(pcm, cfg, monkeypatch)
    P, x = E._layer12_frame(pcm, cfg)
    ana_t = {k: torch.as_tensor(v.copy()) for k, v in ana.items()}
    got = E._fetch_frames(E._layer12_back(ana_t, cfg, P, x)) + b"\x00"
    assert got == want


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chain_equals_host_route_on_the_cpu(case):
    pcm, cfg = case_input(*case)
    out = E.encode_layer12_fast(pcm, cfg, "cpu")
    assert out == l12_host_route(pcm, cfg, "cpu")
    assert len(out) == -(-len(pcm) // E._frame_bytes(cfg)[0]) \
        * (E._Layer12Plan(cfg, 1).frame_bytes) + 1


def test_a_malformed_frame_raises_after_the_download(monkeypatch):
    real = L12.marshal_frames

    def broken(*args):
        values, lengths, crc = real(*args)
        lengths = lengths.clone()
        lengths[0, 5] = 33
        lengths[2, 0] -= 1
        return values, lengths, crc

    monkeypatch.setattr(L12, "marshal_frames", broken)
    fetches = E.fetches
    pcm, cfg = case_input(*CASES[0])
    with pytest.raises(RuntimeError, match="2 frame.*1 element length"):
        E.encode_layer12_fast(pcm, cfg, "cpu")
    assert E.fetches == fetches + 1


def test_plain_pack_drops_bits_past_the_frame():
    """A frame whose lengths overrun keeps its own byte range: the next
    frame's bytes are untouched."""
    values = torch.tensor([[-1, -1, -1], [0x12345678, 0, 0]],
                          dtype=torch.int32)
    lengths = torch.tensor([[32, 32, 32], [32, 16, 16]], dtype=torch.int32)
    buf = P12.pack_frames(values, lengths, 8)
    status, frames = P12.split(buf)
    assert status.tolist() == [1, 0]
    assert frames.numpy().tobytes() == b"\xff" * 8 + \
        b"\x12\x34\x56\x78\x00\x00\x00\x00"


def test_the_layer12_spans_in_a_trace(tmp_path):
    """A trace of each route holds its stages under the JAX package's
    names (runtime.profiling.SPANS_L12): the card chain's joint decision
    runs inside K5, under greedy_allocation."""
    from mp3tpu_torch.runtime.profiling import SPANS_L12, trace
    from mp3tpu_torch.tools.trace_stages import span_breakdown
    pcm, cfg = case_input(*FIXTURES[1])
    want = {"card": ("analyze_frames", "greedy_allocation", "quantize_l2",
                     "_marshal_layer12", "pack_elements", "fetch"),
            "host": ("analyze_frames", "joint_mode", "greedy_allocation",
                     "quantize_l2", "_marshal_layer12", "pack_elements")}
    for route, fn in (("card", E.encode_layer12_fast),
                      ("host", l12_host_route)):
        with trace(str(tmp_path / route), "cpu"):
            fn(pcm, cfg, "cpu")
        spans = span_breakdown(str(tmp_path / route / "trace.json"),
                               SPANS_L12)["spans"]
        got = {n for n in SPANS_L12 if spans[n]["count"]}
        assert got == set(want[route]), (route, got)
        assert spans["quantize_l2"]["count"] == 2
