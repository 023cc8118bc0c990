"""The multi-rank clip's analysis as two CUDA graphs around the
automaton's all-gather, checked on the CPU (``parallel/clip.py``).

On the card a rank's chunk lanes run psy with the composed automaton
maps as one graph (``_psy_maps``, stage "sharded_psy"), all-gather the
maps on the caller's stream, and run the global prefix, the block types,
the spectra and the scfsi flags as a second graph (``_spectra``, stage
"sharded_spectra").  These tests check that both bodies can be captured
(an aten-op log on "cpu" and "meta": no host read, no tensor from host
data, no op across devices), and run the captured host side
(``_captured_lanes``) with a stand-in capture against the lane-by-lane
yardstick (``_per_lane``) at world size 1 and 2 on gloo, in
subprocesses: every output equal, call after call on one key, no output
in a replay's pool, each graph's key holding the rank.  The graphs
themselves run on the card in chip_smoke.py phase 11.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder
from mp3tpu_torch.parallel import clip
from mp3tpu_torch.tables import mpeg
from test_torch_graph import HOST_DATA, HOST_READS, OpLog
from test_torch_parallel import _signal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (version, sampling_frequency) of the cases: MPEG-1 44.1 kHz, LSF 22.05
VERSIONS = {"mpeg1": (mpeg.MPEG1, 0), "lsf": (mpeg.MPEG2_LSF, 0)}
#: granules of a chunk
C = 16


def lanes_of(K, nch=2, seconds=1.0):
    """The chunk grid of encode_layer3_sharded for K chunks of C granules
    of the test signal: ext (K*nch, C+2, 576) and halo (K*nch, 2, 576)
    float32, lanes chunk-major."""
    pcm = _signal(seconds)[:nch]
    G = K * C
    flat = np.zeros((nch, G * 576), np.int16)
    n = min(G * 576, pcm.shape[1])
    flat[:, :n] = pcm[:, :n]
    flat = flat.reshape(nch, G, 576)
    halo4 = np.zeros((K, nch, 4, 576), np.int16)
    for k in range(1, K):
        halo4[k] = flat[:, k * C - 4:k * C]
    grid = flat.reshape(nch, K, C, 576).transpose(1, 0, 2, 3)
    ext = np.concatenate([halo4[:, :, 2:], grid], axis=2)
    return (torch.tensor(ext.reshape(K * nch, C + 2, 576), dtype=torch.float32),
            torch.tensor(halo4[:, :, :2].reshape(K * nch, 2, 576),
                         dtype=torch.float32))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("version", VERSIONS)
def test_both_bodies_are_capture_safe(version, device):
    """psy with the maps, then the spectra from gathered maps, under an
    aten-op log: no host read of a device value, no tensor from host
    data, every tensor of every op on the run's device."""
    enc = Layer3SegmentEncoder(*VERSIONS[version], device)
    ext, halo = (t.to(device) for t in lanes_of(2))
    with OpLog() as log:
        p = clip._psy_maps(enc, ext, halo)
    allmaps = torch.cat([p["maps"], p["maps"]]).reshape(4, 2, 4)
    with OpLog() as log2:
        s = clip._spectra(enc, ext, p["attack"], p["ratio_l"], p["ratio_s"],
                          allmaps, 1, 2)
    for lg, out in ((log, p), (log2, s)):
        names = {op for op, _ in lg.ops}
        assert len(lg.ops) > 50
        assert not names & HOST_READS, names & HOST_READS
        assert not names & HOST_DATA, names & HOST_DATA
        elsewhere = [(op, devs) for op, devs in lg.ops if devs - {device}]
        assert not elsewhere, elsewhere[:5]
        assert all(t.device.type == device for t in out.values())
    assert p["maps"].shape == (4, 4)
    assert ("scfsi" in s) == (version == "mpeg1")


_WORKER = textwrap.dedent("""
    import pickle, sys
    from types import SimpleNamespace
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    torch.set_num_threads(1)
    from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder
    from mp3tpu_torch.ops import graphs
    from mp3tpu_torch.parallel import clip
    from mp3tpu_torch.parallel.corpus import init_distributed
    from mp3tpu_torch.parallel.sharding import make_mesh
    rank, world, url, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], sys.argv[5])
    with open(inp, "rb") as f:
        job = pickle.load(f)

    def ptr(t):
        return t.untyped_storage().data_ptr()

    class PoolLog(TorchDispatchMode):
        # the tensors an op allocates: a graph's temporaries
        def __init__(self):
            super().__init__()
            self.made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            given = {ptr(t) for t in tree_leaves((args, kwargs))
                     if isinstance(t, torch.Tensor)}
            self.made += [t for t in tree_leaves(res)
                          if isinstance(t, torch.Tensor)
                          and ptr(t) not in given]
            return res

    pools = []

    def record(fn):
        def replay():
            with PoolLog() as log:
                fn()
            pools.append(log.made)
        return SimpleNamespace(replay=replay)

    init_distributed(url, world, rank, "gloo")
    mesh = make_mesh("cpu", world)
    enc = Layer3SegmentEncoder(*job["version"], "cpu")
    res = dict(calls=[], in_pool=[], keys=None)
    for ext, halo in job["calls"]:
        mine = slice(rank * 4, rank * 4 + 4)       # Kl = 2 chunks x 2 ch
        got = clip._captured_lanes(enc, ext[mine], halo[mine], mesh, 2, 2,
                                   record, lambda body, keep: keep(
                                       body()[0]))
        want = clip._per_lane(enc, ext[mine], halo[mine], mesh, 2, 2)
        res["calls"].append(({k: v.numpy() for k, v in got.items()},
                             {k: v.numpy() for k, v in want.items()}))
        entries = list(clip.GRAPHS.entries.values())
        res["in_pool"].append(sorted(
            k for e in entries for k, v in e.outputs[
                next(iter(e.outputs))].items()
            if pools and any(ptr(m) == ptr(v) for m in pools[-1])))
    res["keys"] = [k[0] for k in clip.GRAPHS.entries]
    res["ranks"] = [dict(k[1][1][0])["rank"] for k in clip.GRAPHS.entries]
    res["by_stage"] = graphs.by_stage()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""")


def _run_world(tmp_path, world, version):
    """Each rank of a gloo group of `world` runs both forms on its 2
    chunks of 2 channels, three calls: the PCM, other PCM, the PCM."""
    rendezvous = tmp_path / f"rdv_{world}_{version}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    inp = tmp_path / "job.pkl"
    inp.write_bytes(pickle.dumps(dict(
        version=VERSIONS[version],
        calls=[lanes_of(2 * world, seconds=s) for s in (1.0, 0.8, 1.0)])))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    outs = [tmp_path / f"out_{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         f"file://{rendezvous}", str(inp), str(outs[r])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-3000:]
    return [pickle.loads(o.read_bytes()) for o in outs]


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("world", [1, 2])
def test_two_graphs_equal_per_lane(tmp_path, world, version):
    """At world size 1 and 2 (gloo), three calls on one key (a capture,
    a replay on other PCM, a replay): each rank's two-graph analysis ==
    its lane-by-lane analysis on every output, exactly; its outputs are
    static tensors, none in the last replay's pool; one key a stage,
    holding the rank; captures and replays counted by stage."""
    short = False
    for rank, res in enumerate(_run_world(tmp_path, world, version)):
        for got, want in res["calls"]:
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert res["in_pool"] == [[], [], []]
        assert sorted(res["keys"]) == ["sharded_psy", "sharded_spectra"]
        assert res["ranks"] == [rank, rank]
        for stage in ("sharded_psy", "sharded_spectra"):
            assert res["by_stage"][stage] == (1, 2), res["by_stage"]
        calls = res["calls"]
        assert not np.array_equal(calls[0][0]["xr"], calls[1][0]["xr"])
        short |= bool((calls[0][0]["block_type"] == 2).any())
    # a transient switches blocks: the automaton's carry takes part
    assert short
