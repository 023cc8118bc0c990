"""The named spans of the port's entry points (``runtime.profiling``) on
the CPU: a traced encode of ``encode_layer3_fast``,
``encode_corpus_batched`` and ``encode_layer12_fast`` holds each span of
its path as many times as its segments, clips and groups ask, and gives
the untraced encode's bytes; with no profiler running a span touches no
profiler machinery, so the encodes run with ``record_function`` made to
raise.  ``settle``'s re-encodes open a span of their cause around
their ``run_final``: ``guard_retry`` and ``rebucket``, each forced on a
1 s clip."""
import collections
import json

import pytest
import torch

from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.encoder import encode_layer3_fast, encode_layer12_fast
from mp3tpu_torch.parallel.corpus import encode_corpus_batched
from mp3tpu_torch.runtime import profiling
from mp3tpu_torch.tables import mpeg
from mp3tpu_torch.tools.signals import make_signal
from test_torch_one_wait import _force_one_retry

torch.set_num_threads(1)

L3_KW = dict(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128)


def _one_shot(**kw):
    """A 1 s stereo clip: one segment."""
    return [encode_layer3_fast(make_signal(1.0, 44100),
                               EncoderConfig(sample_rate_hz=44100, **L3_KW),
                               "cpu", **kw)]


def _corpus():
    """Three clips at lane batch 2: two groups of one segment each, the
    second clip shorter than its group."""
    pcm = make_signal(1.0, 44100)
    outs, _ = encode_corpus_batched(
        [(pcm, 44100), (pcm[:30000], 44100), (pcm, 44100)], L3_KW, "cpu",
        batch=2)
    return outs


def _layer12():
    """A 1 s Layer II joint-stereo item with the CRC."""
    cfg = EncoderConfig(layer=2, mode=mpeg.MODE_JOINT, bitrate_kbps=192,
                        sample_rate_hz=48000, error_protection=True)
    return [encode_layer12_fast(make_signal(1.0, 48000), cfg, "cpu")]


#: each entry point's spans in its traced encode, by name
WANT = {
    "encode_layer3_fast": (_one_shot, profiling.SPANS, dict(
        dict.fromkeys(profiling.SPANS, 1), outer_loop=2, upload=2,
        **dict.fromkeys(profiling.ON_RETRY, 0))),
    "encode_corpus_batched": (_corpus, profiling.SPANS
                              + profiling.SPANS_CORPUS, dict(
        # once a call
        _Layer3Framing=1,
        # once a clip
        frame=3, _clip_records=3, settle=3, _stitch_flat=3, scfsi_frames=3,
        NativeAssembler=3, **{"native assembly": 3,
                              "NativeAssembler.finish": 3},
        # once a group (of one segment)
        upload=2, analyze_demand_fused=2,
        outer_loop=4, _plan_budgets_corpus=2, encode_final=2,
        granule_payload=2, compact_payload=2, pack_state=2, fetch_async=2,
        fetch=2,
        # the one segment program and the one-shot scan span: not here
        encode_segment_fused=0, scan_budgets=0,
        **dict.fromkeys(profiling.ON_RETRY, 0))),
    "encode_layer12_fast": (_layer12, profiling.SPANS_L12, dict(
        dict.fromkeys(profiling.SPANS_L12, 1), quantize_l1=0,
        quantize_l2=2)),
}


@pytest.mark.parametrize("entry", sorted(WANT))
def test_a_traced_encode_holds_each_span(entry, tmp_path):
    fn, names, want = WANT[entry]
    plain = fn()
    with profiling.trace(str(tmp_path), "cpu"):
        out = fn()
    assert out == plain
    with open(tmp_path / "trace.json") as f:
        got = collections.Counter(
            e["name"] for e in json.load(f)["traceEvents"]
            if e.get("cat") == "user_annotation")
    assert {n: got[n] for n in names} == want
    # no span but the listed ones
    assert set(got) <= set(names)


@pytest.mark.parametrize("entry", sorted(WANT))
def test_spans_are_inert_without_a_profiler(entry, monkeypatch):
    fn = WANT[entry][0]
    plain = fn()

    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) outside a trace")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert fn() == plain


def test_every_span_name_is_listed_once():
    """Each list names a span once; the Layer III lists do not overlap."""
    for names in (profiling.SPANS, profiling.SPANS_CORPUS,
                  profiling.SPANS_SHARDED, profiling.SPANS_L12):
        assert len(set(names)) == len(names)
    l3 = profiling.SPANS + profiling.SPANS_CORPUS + profiling.SPANS_SHARDED
    assert len(set(l3)) == len(l3)
    assert set(profiling.ON_RETRY) <= set(profiling.SPANS)


def _spans(fn, tmp_path):
    """(name, start, end) of each span of `fn()` traced, by start."""
    with profiling.trace(str(tmp_path), "cpu"):
        out = fn()
    with open(tmp_path / "trace.json") as f:
        spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"])
                        for e in json.load(f)["traceEvents"]
                        if e.get("cat") == "user_annotation"),
                       key=lambda s: s[1])
    return out, spans


def _named(spans, name):
    return [(s, e) for n, s, e in spans if n == name]


def _inside(spans, outer):
    s0, e0 = outer
    return [n for n, s, e in spans
            if s0 <= s and e <= e0 and (s, e) != (s0, e0)]


def test_a_guard_retry_is_one_guard_retry_span(monkeypatch, tmp_path):
    """One overdraw: one ``guard_retry`` inside ``settle``, holding the
    scan's fetch and the one ``run_final``; no ``rebucket``."""
    _force_one_retry(monkeypatch)
    _, spans = _spans(_one_shot, tmp_path)
    (s0, e0), = _named(spans, "settle")
    (s1, e1), = _named(spans, "guard_retry")
    assert s0 <= s1 and e1 <= e0
    inner = _inside(spans, (s1, e1))
    assert inner.count("run_final") == 1 and inner.count("fetch") == 2
    assert len(_named(spans, "run_final")) == 1
    assert not _named(spans, "rebucket")


def test_a_granule_past_its_payload_row_is_a_rebucket_span(tmp_path):
    """A payload row of 8 words, narrower than the clip's granules: each
    re-bucket a ``rebucket`` holding one ``run_final``, the first the
    scan's fetch too; every ``run_final`` inside one; no guard retry."""
    want = _one_shot(pw=8)
    out, spans = _spans(lambda: _one_shot(pw=8), tmp_path)
    assert out == want
    rebuckets = _named(spans, "rebucket")
    assert rebuckets and not _named(spans, "guard_retry")
    assert [_inside(spans, r).count("run_final") for r in rebuckets] == \
        [1] * len(rebuckets)
    assert _inside(spans, rebuckets[0]).count("fetch") == 2
    assert len(_named(spans, "run_final")) == len(rebuckets)


def test_a_clean_encode_opens_no_reencode_span(tmp_path):
    """A 1 s clip that passes both guards at once re-encodes nothing."""
    _, spans = _spans(_one_shot, tmp_path)
    assert _named(spans, "settle")
    assert not any(_named(spans, n) for n in profiling.ON_RETRY)
