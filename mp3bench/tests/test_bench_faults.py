"""The check catches a broken timed path: each cell's run, on the CPU at
a tiny size and with the look for a card skipped (device "cpu"), with a
fault planted under the entry that the window drives, comes out not
correct.  The faults: a step that returns its state unchanged (Layer
III: a segment call hands back the outputs of the key's previous call,
as a replay whose outputs were never refreshed; the block-switching
automaton's carry between segments left at its start; Layer II: the
allocation left at its start, nothing allocated), half of the batch
left out (Layer III: the results of the second half of each segment's
lanes, of a corpus group's clips, never written; the PCM of every
other clip of a corpus, or of the second half of a track, never read;
Layer II: the second half of an item's frames not analysed), a
decision made wrong (K3's stepsize searches held to nine tenths of
each granule's budget: coarser gains, the bits left unspent), and an
answer altered where it is produced (one bit of every frame's data
flipped as the stream is written).  One chip: no exchange between
chips to leave out.  Four of the Layer III faults are planted again in
the album cell made MPEG-2 LSF (24 kHz, 64 kbps, stereo), with one of
LSF's own: every granule's 9-bit scalefac_compress set to 511, the top
of table 2's range, whatever partition its scale factors were written
with."""
import pytest
import torch

from conftest import tiny
from mp3bench import harness


def every_frame(traffic, config):
    """The tiny cell with every frame of the sampled streams checked in
    depth: at a test's size a sample of ten frames may miss the frames
    that a fault spoils."""
    tiny(traffic, config)
    traffic["check"]["frames"] = 10 ** 6


def run(cell, edit=every_frame):
    return harness.run(cell, 2 ** 31 + 23, 0.5, False, device="cpu",
                       edit=edit)


def short_segments(traffic, config):
    """The album cell at chunk 64: several segments a tiny clip, so that
    a segment's state matters."""
    every_frame(traffic, config)
    traffic["args"] = {"chunk": 64}


def lsf(traffic, config):
    """The album cell as MPEG-2 LSF Layer III: 24 kHz, 64 kbps, stereo
    (frames of one granule, 192 bytes), every frame checked."""
    every_frame(traffic, config)
    config.update(sample_rate_hz=24000, bitrate_kbps=64)


def lsf_short_segments(traffic, config):
    lsf(traffic, config)
    traffic["args"] = {"chunk": 64}


def flip_every_frame(data, size, at):
    b = bytearray(data)
    for o in range(0, len(b) - 1 - at, size):
        b[o + at] ^= 0x10
    return bytes(b)


def test_sound_runs_pass():
    assert run("l3-cd-128k.album", short_segments)["correct"]


def test_lsf_sound_runs_pass():
    r = run("l3-cd-128k.album", lsf_short_segments)
    assert r["correct"] and r["check"]["bad_frames"]["value"] == 0


def stale_segment_outputs(monkeypatch):
    from mp3tpu_torch import encoder
    seg = encoder._Layer3Framing.segment
    last = {}

    def stale(self, blocks, *a):
        h = seg(self, blocks, *a)
        return last.setdefault(tuple(blocks.shape), h)
    monkeypatch.setattr(encoder._Layer3Framing, "segment", stale)


def test_l3_segment_outputs_left_unchanged(monkeypatch):
    stale_segment_outputs(monkeypatch)
    assert not run("l3-cd-128k.album", short_segments)["correct"]


def test_lsf_segment_outputs_left_unchanged(monkeypatch):
    stale_segment_outputs(monkeypatch)
    assert not run("l3-cd-128k.album", lsf_short_segments)["correct"]


def leave_out_half_the_lanes(monkeypatch):
    """Every Layer III segment's results for the second half of its lanes
    (rows are lane-major: channel 1 of a one-shot, the second half of a
    corpus group's clips) left out: never written, zero."""
    from mp3tpu_torch import encoder
    fetch = encoder._Layer3Framing.fetch_async

    def half(self, hs, keys=None):
        for h in hs:
            h["side"][h["side"].shape[0] // 2:] = 0
        return fetch(self, hs, keys)
    monkeypatch.setattr(encoder._Layer3Framing, "fetch_async", half)


def test_l3_half_the_lanes_left_out(monkeypatch):
    leave_out_half_the_lanes(monkeypatch)
    assert not run("l3-cd-128k.album", short_segments)["correct"]


@pytest.mark.parametrize("cell", ["l3-cd-128k.album",
                                  "l3-cd-128k.previews"])
def test_l3_answer_altered(monkeypatch, cell):
    from mp3tpu_torch import encoder
    from mp3tpu_torch.parallel import corpus

    class Altered(encoder.NativeAssembler):
        def finish(self):
            return flip_every_frame(super().finish(), 417, 36 + 60)
    monkeypatch.setattr(encoder, "NativeAssembler", Altered)
    monkeypatch.setattr(corpus, "NativeAssembler", Altered)
    assert not run(cell)["correct"]


def test_l3_half_the_clips_left_out(monkeypatch):
    leave_out_half_the_lanes(monkeypatch)
    assert not run("l3-cd-128k.previews")["correct"]


def half_the_pcm_never_read(monkeypatch, every_other_clip):
    """The framing hands on silence for every other clip (a corpus) or
    for the second half of each clip (a track)."""
    import numpy as np
    from mp3tpu_torch import encoder
    frame, calls = encoder._Layer3Framing.frame, []

    def half(self, pcm):
        pcm = np.array(pcm)
        calls.append(None)
        if every_other_clip:
            if len(calls) % 2 == 0:
                pcm[:] = 0
        else:
            pcm[:, pcm.shape[1] // 2:] = 0
        return frame(self, pcm)
    monkeypatch.setattr(encoder._Layer3Framing, "frame", half)


@pytest.mark.parametrize("cell", ["l3-cd-128k.previews",
                                  "l3-cd-128k.album"])
def test_l3_half_the_pcm_never_read(monkeypatch, cell):
    """The framing hands on silence for every other clip of a corpus,
    and for the second half of a track: streams that code silence for
    music the PCM holds."""
    half_the_pcm_never_read(monkeypatch, cell.endswith("previews"))
    assert not run(cell)["correct"]


def test_lsf_half_the_pcm_never_read(monkeypatch):
    half_the_pcm_never_read(monkeypatch, False)
    r = run("l3-cd-128k.album", lsf)
    assert not r["correct"]
    assert r["check"]["silenced_pct"]["value"] > \
        r["check"]["silenced_pct"]["limit"]


def test_l3_block_switch_carry_left_at_its_start(monkeypatch):
    """Each segment starts the block-switching automaton from its
    initial state instead of the state the previous segment left: at a
    boundary inside an attack the windows no longer overlap-add.  The
    sound run of the same cell carries an attack across a boundary."""
    from mp3tpu_torch import encoder
    seg, carried = encoder._Layer3Framing.segment, []

    def record(self, blocks, fsm, *a):
        carried.append(int(torch.as_tensor(fsm).abs().sum()))
        return seg(self, blocks, fsm, *a)

    def frozen(self, blocks, fsm, *a):
        return seg(self, blocks, torch.zeros_like(torch.as_tensor(fsm)),
                   *a)

    def chunk16(traffic, config):
        every_frame(traffic, config)
        traffic["args"] = {"chunk": 16}
    monkeypatch.setattr(encoder._Layer3Framing, "segment", record)
    assert run("l3-cd-128k.album", chunk16)["correct"] and any(carried)
    monkeypatch.setattr(encoder._Layer3Framing, "segment", frozen)
    assert not run("l3-cd-128k.album", chunk16)["correct"]


def stepsize_searches_coarser(monkeypatch):
    from mp3tpu_torch.ops import search
    for fn in ("search_stepsize", "search_walk"):
        real = getattr(search, fn)
        monkeypatch.setattr(
            search, fn, lambda xr, budget, *a, real=real, **k:
            real(xr, budget * 0.9, *a, **k))


def test_l3_stepsize_searches_coarser(monkeypatch):
    stepsize_searches_coarser(monkeypatch)
    assert not run("l3-cd-128k.album")["correct"]


def test_lsf_stepsize_searches_coarser(monkeypatch):
    """At LSF the reservoir holds at most 255 bytes, and sound streams
    fill it: stuffing that the cap forces is legal.  The bits that K3
    leaves unspent still read above ``unspent_pct``'s limit."""
    stepsize_searches_coarser(monkeypatch)
    r = run("l3-cd-128k.album", lsf)
    assert not r["correct"]
    assert r["check"]["unspent_pct"]["value"] > \
        r["check"]["unspent_pct"]["limit"]


def lsf_assembled(monkeypatch, alter):
    """`alter(bytearray, frame offset)` applied to every 192-byte frame
    of each LSF stream as the assembler finishes it."""
    from mp3tpu_torch import encoder

    class Altered(encoder.NativeAssembler):
        def finish(self):
            b = bytearray(super().finish())
            for o in range(0, len(b) - 1, 192):
                alter(b, o)
            return bytes(b)
    monkeypatch.setattr(encoder, "NativeAssembler", Altered)


def test_lsf_answer_altered(monkeypatch):
    def flip(b, o):
        b[o + 21 + 60] ^= 0x10
    lsf_assembled(monkeypatch, flip)
    assert not run("l3-cd-128k.album", lsf)["correct"]


def set_bits(b, pos, width, value):
    for k in range(width):
        byte, bit = divmod(pos + k, 8)
        one = (value >> (width - 1 - k)) & 1
        b[byte] = b[byte] & ~(0x80 >> bit) | (one << (7 - bit))


def test_lsf_scalefac_compress_out_of_its_range(monkeypatch):
    """Every granule's scalefac_compress set to 511 (table 2: widths 3
    and 2 over 11 and 10 long bands, preflag): a decoder reads other
    scale factors, and other lines, than the encoder wrote.  Side info
    after the 4-byte header: main_data_begin 8 bits, 2 private bits,
    then each channel's 63 bits, scalefac_compress after 29 of them."""
    def top(b, o):
        for ch in range(2):
            set_bits(b, 8 * (o + 4) + 10 + 63 * ch + 29, 9, 511)
    lsf_assembled(monkeypatch, top)
    r = run("l3-cd-128k.album", lsf)
    assert not r["correct"] and r["check"]["bad_frames"]["value"] > 0


def test_l2_allocation_left_at_its_start(monkeypatch):
    from mp3tpu_torch import encoder
    from mp3tpu_torch.tables import layer12 as T12
    allocate = encoder.A12.allocate

    def nothing(smr, scfsi, layer, table, nch, sblimit, adb, *a):
        """K5's result at the allocation's start: nothing allocated,
        every bit after the allocation fields left over."""
        out = allocate(smr, scfsi, layer, table, nch, sblimit, adb, *a)
        nbal = torch.as_tensor(T12.ALLOC[table]["nbal"][:sblimit],
                               device=out["ba"].device)
        own = torch.arange(sblimit, device=nbal.device)[None, :] < \
            out["jsbound"].to(torch.int64)[:, None]
        bbal = (nbal * torch.where(own, nch, 1)).sum(1)
        out["ba"] = out["ba"] * 0
        out["adb_left"] = (adb - 48 - bbal).to(out["adb_left"].dtype)
        return out
    monkeypatch.setattr(encoder.A12, "allocate", nothing)
    assert not run("l2-dab-192k.spots")["correct"]


def test_l2_half_the_frames_left_out(monkeypatch):
    from mp3tpu_torch import encoder
    analysis = encoder._layer12_analysis

    def half(pcm, P, dev):
        pcm = pcm.copy()
        pcm[:, pcm.shape[1] // 2:] = 0
        return analysis(pcm, P, dev)
    monkeypatch.setattr(encoder, "_layer12_analysis", half)
    assert not run("l2-dab-192k.spots")["correct"]


def test_l2_answer_altered(monkeypatch):
    from mp3tpu_torch import encoder
    fetch = encoder._fetch_frames
    monkeypatch.setattr(encoder, "_fetch_frames",
                        lambda buf: flip_every_frame(fetch(buf), 576, 200))
    assert not run("l2-dab-192k.spots")["correct"]
