"""The corpus path of the port (mp3tpu_torch.parallel.corpus and
ops/resv.scan_budgets_batched) on the CPU, after tests/test_corpus.py.

The batched reservoir scan, the corpus budget plan and the share of a
process are exact integer functions and must equal the JAX package's.
Whole streams are held to the frame grid (length), and to the decoded
SNR of the port's one-shot encode and of the JAX package's batched
encode within 0.5 dB per channel (float32 batch-shape round-off may move
single quantized lines).
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.ops import jaxresv
from mp3tpu.parallel import corpus as jcorpus
from mp3tpu.tables import mpeg
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.decoder import decode_mp3
from mp3tpu_torch.decoder.layer3 import snr_db
from mp3tpu_torch.encoder import (_Layer3Framing, _plan_segments,
                                  encode_layer3_fast, encode_layer12_fast)
from mp3tpu_torch.ops import resv
from mp3tpu_torch.parallel import corpus as tcorpus

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (mode, kbps, rate): MPEG-1 stereo and mono, MPEG-2 LSF mono
FRAMINGS = [(mpeg.MODE_STEREO, 128, 44100), (mpeg.MODE_MONO, 64, 44100),
            (mpeg.MODE_MONO, 32, 22050)]


def _framing(mode, kbps, rate):
    return _Layer3Framing(EncoderConfig(layer=3, mode=mode,
                                        bitrate_kbps=kbps,
                                        sample_rate_hz=rate), "cpu")


def _scan_inputs(rng, B, nch, G):
    """pe (float64) and demand like the demand encode's: mostly quiet,
    some granules far over the mean, a few silent."""
    pe = rng.gamma(2.0, 300.0, (B, nch, G))
    demand = rng.randint(0, 4096, (B, nch, G))
    demand[rng.rand(B, nch, G) < 0.5] //= 4
    demand[rng.rand(B, nch, G) < 0.05] = 0
    return pe, demand.astype(np.int32)


@pytest.mark.parametrize("framing", FRAMINGS, ids=["st128", "mono64",
                                                   "lsf32"])
def test_scan_budgets_batched_matches_jax(framing):
    L3 = _framing(*framing)
    nch, mode_gr = L3.nch, L3.mode_gr
    rng = np.random.RandomState(framing[1])
    F, B = 37, 4
    pe, demand = _scan_inputs(rng, B, F, mode_gr * nch)
    size0 = rng.randint(0, L3.resv_max + 1, B) // 8 * 8
    args = (L3.mean_bits, L3.resv_max, mode_gr, nch, 28)
    want_b, want_s = jaxresv.scan_budgets_batched(
        jnp.asarray(pe), jnp.asarray(demand),
        jnp.asarray(size0, jnp.int32), *args)
    got_b, got_s = resv.scan_budgets_batched(
        torch.as_tensor(pe), torch.as_tensor(demand),
        torch.as_tensor(size0), *args)
    assert got_b.dtype == torch.int32 and got_s.dtype == torch.int32
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("framing", FRAMINGS, ids=["st128", "mono64",
                                                   "lsf32"])
def test_plan_budgets_corpus_matches_jax(framing):
    L3 = _framing(*framing)
    nch, mode_gr = L3.nch, L3.mode_gr
    B = 3
    # a ramp, a full and a padded segment
    plan = tuple(_plan_segments(300, (64, 128)))
    assert len(plan) == 3 and plan[-1][1] < plan[-1][2]
    rng = np.random.RandomState(7)
    pes, p23s = [], []
    for _, _, n_pad in plan:
        pe, dm = _scan_inputs(rng, B, nch, n_pad)
        pes.append(pe.reshape(-1))
        p23s.append(dm.reshape(-1))
    args = (plan, B, nch, mode_gr, L3.mean_bits, L3.resv_max, 28)
    want_rows, want_t, want_d = jcorpus._plan_budgets_corpus(
        tuple(jnp.asarray(p) for p in pes),
        tuple(jnp.asarray(d) for d in p23s), *args)
    got_rows, got_t, got_d = tcorpus._plan_budgets_corpus(
        [torch.as_tensor(p) for p in pes], [torch.as_tensor(d) for d in p23s],
        *args)
    for g, w in zip(got_rows, want_rows):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("G", [5, 300, 1030, 1300])
def test_clip_records_stitch_like_the_group(G):
    """Clip b's records, cut out of its group's segments, stitch to what
    the JAX package stitches from the whole group with lane0=b*nch and the
    clip's G (tail granules past G leave spans and offsets together)."""
    from mp3tpu import encoder as jencoder
    from mp3tpu_torch import encoder as tencoder
    rng = np.random.RandomState(G)
    nch, B = 2, 3
    plan = _plan_segments(1300, (256, 1024))
    sides, flats, segs = [], [], []
    for _, _, n_pad in plan:
        p23 = rng.randint(0, 700, B * nch * n_pad)
        p23[rng.rand(p23.size) < 0.2] = 0
        side = np.zeros((p23.size, 19), np.int16)
        side[:, 0] = p23
        words = int(((p23 + 31) >> 5).sum())
        sides.append(side)
        flats.append(rng.randint(0, 2 ** 32, words + 40, dtype=np.uint64)
                     .astype(np.uint32))
        lane = torch.arange(p23.size)
        segs.append(dict(xr=lane, ratio_l=lane, ratio_s=lane,
                         block_type=lane, qss=lane,
                         scfsi=torch.arange(B * nch)))
    got = [dict(side=s, payload=f, scfsi=np.arange(B * nch))
           for s, f in zip(sides, flats)]
    demand = torch.arange(B * nch * 1300).reshape(B, nch, 1300)
    for b in range(B):
        cplan, csegs, cgot = tcorpus._clip_records(b, G, nch, plan, segs,
                                                   got, demand, demand)
        assert sum(n for _, n, _ in cplan) == G
        want = jencoder._stitch_flat(plan, sides, flats, nch, lane0=b * nch,
                                     G=G)
        have = tencoder._stitch_flat(cplan, [c["side"] for c in cgot],
                                     [c["payload"] for c in cgot], nch)
        np.testing.assert_array_equal(have[0], want[0])
        np.testing.assert_array_equal(have[1], want[1])
        for (pos, n, n_pad), s, c in zip(cplan, csegs, cgot):
            lo = b * nch * n_pad
            assert s["xr"].tolist() == list(range(lo, lo + nch * n_pad))
            assert s["scfsi"].tolist() == c["scfsi"].tolist() == \
                [b * nch, b * nch + 1]
            assert torch.equal(s["target"], demand[b, :, pos:pos + n])


@pytest.mark.parametrize("n,nproc", [(10, 2), (7, 3), (3, 8), (1000, 4)])
def test_local_share_matches_jax(n, nproc):
    seen = []
    for pid in range(nproc):
        got = tcorpus.local_share(n, process_id=pid, num_processes=nproc)
        assert got == jcorpus.local_share(n, process_id=pid,
                                          num_processes=nproc)
        seen.extend(range(*got))
    assert seen == list(range(n))


def _mono_clips():
    """tests/test_corpus.py's mono clips of 0.6, 0.9 and 1.2 s."""
    rng = np.random.RandomState(5)
    clips = []
    for s in range(3):
        n = int((0.6 + 0.3 * s) * 44100)
        t = np.arange(n) / 44100.0
        x = (0.3 * np.sin(2 * np.pi * (350 + 60 * s) * t)
             + 0.03 * rng.randn(n))
        clips.append((np.clip(x[None, :] * 22000, -32768, 32767)
                      .astype(np.int16), 44100))
    return clips


def _stereo_clips():
    """tests/test_corpus.py's stereo clips of 0.6 and 1.0 s: the shorter
    one's tail granules past its length are not silent."""
    rng = np.random.RandomState(11)
    clips = []
    for s, secs in enumerate((0.6, 1.0)):
        n = int(secs * 44100)
        t = np.arange(n) / 44100.0
        left = 0.3 * np.sin(2 * np.pi * (350 + 60 * s) * t) \
            + 0.03 * rng.randn(n)
        right = 0.25 * np.sin(2 * np.pi * (500 + 80 * s) * t) \
            + 0.03 * rng.randn(n)
        clips.append((np.clip(np.stack([left, right]) * 22000,
                              -32768, 32767).astype(np.int16), 44100))
    return clips


def _snrs(pcm, out):
    dec, _ = decode_mp3(out)
    return [float(snr_db(pcm[c].astype(np.float64), dec[:, c]))
            for c in range(pcm.shape[0])]


@pytest.mark.parametrize("case", ["mono_batch3", "stereo_mixed_lengths"])
def test_encode_corpus_batched(case):
    if case == "mono_batch3":
        clips, batch = _mono_clips(), 3
        kw = dict(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=64)
    else:
        clips, batch = _stereo_clips(), 2
        kw = dict(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128)
    outs, stats = tcorpus.encode_corpus_batched(clips, kw, "cpu",
                                                batch=batch)
    assert stats["clips"] == len(clips) and stats["x_realtime"] > 0
    assert stats["audio_s"] == pytest.approx(
        sum(p.shape[1] / r for p, r in clips))
    jouts, _ = jcorpus.encode_corpus_batched(clips, kw, batch=batch)
    for (pcm, rate), out, jout in zip(clips, outs, jouts):
        single = encode_layer3_fast(pcm, EncoderConfig(sample_rate_hz=rate,
                                                       **kw), "cpu")
        assert len(out) == len(single) == len(jout)
        assert out[0] == 0xFF and (out[1] & 0xF0) == 0xF0
        for s_b, s_s, s_j in zip(_snrs(pcm, out), _snrs(pcm, single),
                                 _snrs(pcm, jout)):
            assert abs(s_b - s_s) < 0.5, (s_b, s_s)
            assert abs(s_b - s_j) < 0.5, (s_b, s_j)
            assert s_b > 10.0, s_b


def test_encode_corpus_layer12():
    """tests/test_corpus.py's Layer II corpus: three stereo clips through
    the thread pool, each equal to its own encode."""
    rng = np.random.RandomState(0)
    clips = []
    for s in range(3):
        t = np.arange(int(0.3 * 44100)) / 44100.0
        x = np.clip((0.2 * np.sin(2 * np.pi * (300 + 100 * s) * t)
                     + 0.02 * rng.randn(len(t))) * 20000,
                    -32768, 32767).astype(np.int16)
        clips.append((np.stack([x, x]), 44100))
    kw = dict(layer=2, mode=mpeg.MODE_STEREO, bitrate_kbps=192)
    outs, stats = tcorpus.encode_corpus(clips, kw, "cpu",
                                        encode=encode_layer12_fast)
    assert len(outs) == 3 and all(len(o) > 500 for o in outs)
    assert stats["clips"] == 3 and stats["audio_s"] > 0.8
    for (pcm, rate), out in zip(clips, outs):
        assert out == encode_layer12_fast(
            pcm, EncoderConfig(sample_rate_hz=rate, **kw), "cpu")


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from mp3tpu_torch.parallel.corpus import (encode_corpus,
                                              init_distributed, local_share)
    from mp3tpu_torch.tables import mpeg
    pid, url = int(sys.argv[1]), sys.argv[2]
    p, n = init_distributed(url, 2, pid, "gloo")
    assert n == 2 and p == pid, (p, n)
    def clip(seed):
        rng = np.random.RandomState(seed)
        t = np.arange(int(0.5 * 44100)) / 44100.0
        x = (0.25 * np.sin(2 * np.pi * (300 + 50 * seed) * t)
             + 0.02 * rng.randn(len(t)))
        return (np.clip(x[None, :] * 20000, -32768, 32767)
                .astype(np.int16), 44100)
    s, e = local_share(4)
    outs, stats = encode_corpus(
        [clip(i) for i in range(s, e)],
        dict(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=64), "cpu")
    ok = all(len(o) > 500 and o[0] == 0xFF for o in outs)
    # results first, then teardown once both ranks are done with the group
    print("SHARE", p, s, e, int(ok), stats["x_realtime"], flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""")


def test_two_process_distributed_corpus(tmp_path):
    """Two gloo processes: each owns a disjoint contiguous share of a
    4-clip corpus and encodes it (tests/test_corpus.py's twin)."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    url = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), url],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env, cwd=REPO) for pid in range(2)]
    try:
        said = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    # both workers' whole stderr, so that a failure shows its peer's too
    report = "\n".join(f"--- rank {pid}: rc {p.returncode}\n"
                        f"{err.decode(errors='replace')}"
                        for pid, (p, (_, err)) in enumerate(zip(procs, said)))
    assert all(p.returncode == 0 for p in procs), report
    outs = [out.decode() for out, _ in said]
    rows = sorted(o.split("SHARE")[1].split() for o in outs)
    assert [r[:3] for r in rows] == [["0", "0", "2"], ["1", "2", "4"]], rows
    assert all(r[3] == "1" for r in rows), rows
    assert all(float(r[4]) > 0.0 for r in rows), rows
