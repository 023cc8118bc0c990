"""The multi-rank paths of the port (mp3tpu_torch.parallel.sharding,
clip and dryrun) on the CPU, with gloo process groups in subprocesses,
after tests/test_sharding.py and tests/test_clip_sharded.py.

encode_sharded on 2 ranks must equal the port's own per-chunk
computation with host-sliced halos exactly (same shapes on one CPU),
and the JAX package's encode_sharded as closely as tests/test_sharding.py
holds that to its own per-chunk run.  encode_layer3_sharded at 1 and 2 ranks must give every rank the same
stream, block types equal to the port's one-shot encode at the same
chunk (the automaton composed from all-gathered maps is exact), and the
frame grid (length) and decoded SNR within 0.5 dB per channel of the
port's one-shot and of the JAX package's one-shot at that chunk.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mp3tpu.config import EncoderConfig as JEncoderConfig
from mp3tpu.encoder import encode_layer3_fast as jencode
from mp3tpu.tables import mpeg
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.decoder import decode_mp3
from mp3tpu_torch.decoder.layer3 import snr_db, stream_block_types
from mp3tpu_torch.encoder import encode_layer3_fast
from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder
from mp3tpu_torch.ops import loop

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 16
# (rate, kbps, seconds): MPEG-1 and MPEG-2 LSF, stereo
CLIPS = [(44100, 128, 2.0), (22050, 64, 1.5)]


def _signal(seconds=2.0, rate=44100):
    """tests/test_clip_sharded.py's signal: two tones, noise and two
    transients, so that short blocks and the cross-chunk automaton
    engage."""
    rng = np.random.RandomState(11)
    t = np.arange(int(seconds * rate)) / rate
    x = 0.25 * np.sin(2 * np.pi * 440 * t) + 0.03 * rng.randn(len(t))
    y = 0.2 * np.sin(2 * np.pi * 554 * t) + 0.03 * rng.randn(len(t))
    for frac in (0.3, 0.7):
        pos = int(frac * seconds * rate)
        x[pos:pos + 200] += 0.5 * np.hanning(200)[:len(x) - pos]
    return np.clip(np.stack([x, y]) * 24000, -32768, 32767).astype(np.int16)


def _stationary(G):
    """tests/test_sharding.py's low-level tone (no attacks), as blocks."""
    tt = np.arange(G * 576) / 44100.0
    return (1500 * np.sin(2 * np.pi * 200.0 * tt)).astype(np.float32) \
        .reshape(G, 576)


def _cfg(rate, kbps, cls=EncoderConfig):
    return cls(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=kbps,
               sample_rate_hz=rate)


_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from mp3tpu_torch.config import EncoderConfig
    from mp3tpu_torch.parallel.clip import encode_layer3_sharded
    from mp3tpu_torch.parallel.corpus import init_distributed
    from mp3tpu_torch.parallel.dryrun import dryrun_multichip
    from mp3tpu_torch.parallel.sharding import encode_sharded, make_mesh
    rank, world, url, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], sys.argv[5])
    with open(inp, "rb") as f:
        job = pickle.load(f)
    init_distributed(url, world, rank, "gloo")
    mesh = make_mesh("cpu", world)
    blocks = job["blocks"]
    sh = encode_sharded(mesh, blocks,
                        np.full(len(blocks), 900.0, np.float32), 1, 0, "cpu")
    res = dict(sharded={k: sh[k].numpy() for k in
                        ("ix", "part2_3_length", "pe", "total_demand",
                         "block_type")})
    for rate, kbps, pcm in job["clips"]:
        cfg = EncoderConfig(layer=3, mode=job["mode"], bitrate_kbps=kbps,
                            sample_rate_hz=rate)
        res[rate] = encode_layer3_sharded(pcm, cfg, "cpu", mesh=mesh,
                                          chunk=job["chunk"])
    res["dryrun"] = dryrun_multichip(world, "cpu")
    # results first, then teardown once every rank is done with the group:
    # a rank that destroys its pairs while a peer still uses them can take
    # that peer down, and its results with it
    with open(out, "wb") as f:
        pickle.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""")


def _jax_encode_sharded(blocks):
    """The JAX package's encode_sharded on a 1-device CPU mesh, budget
    900 a granule."""
    import jax
    from mp3tpu.parallel import sharding as jsharding
    out = jsharding.encode_sharded(
        jsharding.make_mesh(devices=jax.devices()[:1]), blocks,
        np.full(len(blocks), 900.0, np.float32), 1, 0, 44100.0)
    return {k: np.asarray(out[k]) for k in
            ("ix", "part2_3_length", "pe", "block_type", "total_demand")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [rank 0's results, rank 1's, ...]} from gloo groups
    of 1 and 2 processes, run side by side, and under "jax" the JAX
    package's encode_sharded of the same blocks, computed here while the
    groups run."""
    tmp = tmp_path_factory.mktemp("parallel")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    inp = tmp / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump(dict(blocks=_stationary(16), chunk=CHUNK,
                         mode=mpeg.MODE_STEREO,
                         clips=[(rate, kbps, _signal(secs, rate))
                                for rate, kbps, secs in CLIPS]), f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    jobs = []
    for world in (1, 2):
        url = f"file://{tmp / f'rendezvous{world}'}"
        for rank in range(world):
            out = tmp / f"w{world}r{rank}.pkl"
            jobs.append((world, out, subprocess.Popen(
                [sys.executable, str(script), str(rank), str(world), url,
                 str(inp), str(out)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, env=env, cwd=REPO)))
    res = {1: [], 2: []}
    try:
        res["jax"] = _jax_encode_sharded(_stationary(16))
        said = []
        for world, out, p in jobs:
            err = p.communicate(timeout=300)[1]
            said.append((world, out, p.returncode, err))
    finally:
        for _, _, p in jobs:
            p.kill()
    # every worker's whole stderr, so that a failure shows its peers' too
    report = "\n".join(f"--- world {world}, {out.name}: rc {rc}\n"
                        f"{err.decode(errors='replace')}"
                        for world, out, rc, err in said)
    assert all(rc == 0 for _, _, rc, _ in said), report
    for world, out, _, _ in said:
        with open(out, "rb") as f:
            res[world].append(pickle.load(f))
    return res


@pytest.mark.parametrize("G", [1, 64, 65, 128, 200, 256, 257, 4594])
def test_chunk_size_matches_jax(G):
    from mp3tpu import encoder as jencoder
    from mp3tpu_torch import encoder as tencoder
    assert tencoder._chunk_size(G) == jencoder._chunk_size(G)


@pytest.mark.parametrize("world", [1, 2])
def test_encode_sharded_equals_per_chunk(ranks, world):
    """Each rank's shard equals a single-process run of the same shard
    with its 4-block halo sliced on the host."""
    G = 16
    per = G // world
    blocks = _stationary(G)
    budget = torch.full((per,), 900.0)
    enc = Layer3SegmentEncoder(1, 0, "cpu")
    ix, p23, pe = [], [], []
    for s in range(world):
        pos = per * s
        halo4 = (np.zeros((4, 576), np.float32) if s == 0
                 else blocks[pos - 4: pos])
        ext = np.concatenate([halo4[2:4], blocks[pos: pos + per]])
        a = enc._analyze_chunk(torch.as_tensor(ext),
                               torch.as_tensor(halo4[0:2]),
                               torch.zeros((), dtype=torch.int32))
        bt = a["block_type"]
        out = loop.outer_loop(a["xr"], budget, a["ratio_l"], a["ratio_s"],
                              bt != mpeg.NORM_TYPE, bt, enc.tables("st"))
        ix.append(torch.where((a["xr"] < 0) & (out["ix"] > 0), -out["ix"],
                              out["ix"]).numpy())
        p23.append(out["part2_3_length"].numpy())
        pe.append(a["pe"].numpy())
    for got in ranks[world]:
        sh = got["sharded"]
        np.testing.assert_array_equal(sh["ix"], np.concatenate(ix))
        np.testing.assert_array_equal(sh["part2_3_length"],
                                      np.concatenate(p23))
        np.testing.assert_array_equal(sh["pe"], np.concatenate(pe))
        assert sh["total_demand"].tolist() == \
            [int(np.concatenate(p23).sum())] * world


@pytest.mark.parametrize("world", [1, 2])
def test_encode_sharded_against_jax(ranks, world):
    """The halo exchange and all_reduce against their reference: the JAX
    package's encode_sharded on the same blocks, held as
    tests/test_sharding.py holds it to its per-chunk run.  The two
    libraries round |xr|^0.75 and the psy model's float32 sums apart, so
    pe agrees to the tolerance that file gives across device counts."""
    ref = ranks["jax"]
    for got in ranks[world]:
        sh = got["sharded"]
        np.testing.assert_array_equal(sh["block_type"], ref["block_type"])
        assert (sh["ix"] == ref["ix"]).mean() > 0.999
        assert np.abs(sh["ix"] - ref["ix"]).max() <= 1
        assert np.abs(sh["part2_3_length"].astype(np.int64)
                      - ref["part2_3_length"]).max() <= 16
        np.testing.assert_allclose(sh["pe"], ref["pe"], rtol=5e-3, atol=1e-2)
        assert (abs(int(sh["total_demand"][0]) - int(ref["total_demand"][0]))
                <= 16 * len(ref["part2_3_length"]))


@pytest.fixture(scope="module")
def one_shots():
    """{rate: (pcm, the port's one-shot stream, the JAX package's)} at
    CHUNK."""
    res = {}
    for rate, kbps, secs in CLIPS:
        pcm = _signal(secs, rate)
        res[rate] = (
            pcm, encode_layer3_fast(pcm, _cfg(rate, kbps), "cpu",
                                    chunk=CHUNK),
            jencode(pcm, _cfg(rate, kbps, JEncoderConfig), chunk=CHUNK))
    return res


def _snrs(pcm, out, rate):
    dec, drate = decode_mp3(out)
    assert drate == rate
    return [float(snr_db(pcm[c].astype(np.float64), dec[:, c]))
            for c in range(2)]


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("clip", CLIPS, ids=["44k1", "lsf22k05"])
def test_encode_layer3_sharded(ranks, one_shots, world, clip):
    rate = clip[0]
    pcm, one, jone = one_shots[rate]
    outs = [r[rate] for r in ranks[world]]
    assert all(o == outs[0] for o in outs[1:]), "ranks disagree"
    out = outs[0]
    assert len(out) == len(one) == len(jone)
    assert out[0] == 0xFF and (out[1] & 0xF0) == 0xF0
    bt = stream_block_types(out)
    np.testing.assert_array_equal(bt, stream_block_types(one))
    assert (bt != 0).any()        # the transients switch blocks
    for s_m, s_o, s_j in zip(_snrs(pcm, out, rate), _snrs(pcm, one, rate),
                             _snrs(pcm, jone, rate)):
        assert abs(s_m - s_o) < 0.5, (s_m, s_o)
        assert abs(s_m - s_j) < 0.5, (s_m, s_j)
        assert s_m > 10.0, s_m


@pytest.mark.parametrize("world", [1, 2])
def test_dryrun_multichip(ranks, world):
    outs = [r["dryrun"] for r in ranks[world]]
    assert all(o == outs[0] for o in outs[1:])
    assert len(outs[0]) > 400 and outs[0][0] == 0xFF
