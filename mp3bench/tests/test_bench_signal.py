"""The programme signal: the same for a seed, another for another seed,
its length set by the traffic alone, and its onsets on the beat grid."""
import numpy as np
import torch

from mp3bench import harness
from mp3bench.signals import programme

CPU = torch.device("cpu")


def test_deterministic_for_each_seed():
    a = programme(2 ** 31 + 7, 2.0, 44100, CPU)
    b = programme(2 ** 31 + 7, 2.0, 44100, CPU)
    c = programme(2 ** 31 + 8, 2.0, 44100, CPU)
    assert a.dtype == np.int16 and a.shape == (2, 88200)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])


def test_onsets_on_the_beat():
    x = programme(11, 4.0, 48000, CPU, nch=1, partials=0, noise=0.0,
                  onset_level=0.5)[0].astype(np.float64)
    env = np.sqrt(np.convolve(x * x, np.ones(480) / 480, "same"))
    peaks = [np.argmax(env[i:i + 24000]) + i for i in range(0, 192000, 24000)]
    assert np.allclose(np.diff(peaks), 24000, atol=960)    # 0.5 s apart


def test_lengths_do_not_depend_on_the_seed():
    bench = harness.spec()
    for w in bench["workloads"]:
        _, config, traffic = harness.cell(bench, w["name"])
        traffic["job_seconds"] = [min(s, 2) for s in traffic["job_seconds"]]
        traffic["clips_per_job"] = min(traffic.get("clips_per_job", 1), 2)
        traffic["master_s"] = 6.0
        a = harness.Cycle(traffic, config, 1, CPU)
        b = harness.Cycle(traffic, config, 2 ** 31 + 99, CPU)
        jobs = [(k, p) for p in range(3) for k in range(len(a.kinds))]
        assert [[c.shape for c in a.clips(k, p)] for k, p in jobs] == \
            [[c.shape for c in b.clips(k, p)] for k, p in jobs]
        assert a.audio_s == b.audio_s
        assert not np.array_equal(a.clips(0)[0], b.clips(0)[0])


def test_each_pass_reads_other_slices():
    """Pass p of the cycle encodes other slices of the master signal
    than pass 0, of the same lengths; the slices stay inside it."""
    bench = harness.spec()
    for w in bench["workloads"]:
        _, config, traffic = harness.cell(bench, w["name"])
        traffic["job_seconds"] = [min(s, 2) for s in traffic["job_seconds"]]
        traffic["clips_per_job"] = min(traffic.get("clips_per_job", 1), 2)
        traffic["master_s"] = 6.0
        traffic["passes"] = 3
        cyc = harness.Cycle(traffic, config, 7, CPU)
        for k in range(len(cyc.kinds)):
            for p in (1, 2):
                for a, b in zip(cyc.clips(k), cyc.clips(k, p)):
                    assert a.shape == b.shape
                    assert not np.array_equal(a, b)


def test_the_window_meets_only_warmed_jobs(monkeypatch):
    """Set-up encodes every job of the cycle once; the window encodes
    nothing else (a guard retry's graphs are captured for the content
    that needs them, so the window captures none)."""
    from conftest import tiny
    real, seen = harness.entry, []

    class Recording:
        @staticmethod
        def make(config, device, args):
            enc = real("layer12_fast").make(config, device, args)

            def encode(clips):
                seen.append(tuple(hash(c.tobytes()) for c in clips))
                return enc(clips)
            return encode
    monkeypatch.setattr(harness, "entry", lambda name: Recording)
    r = harness.run("l2-dab-192k.spots", 2 ** 31 + 41, 0.5, False,
                    device="cpu", edit=tiny)
    assert r["correct"]
    n_warm = 2 * 3                     # tiny: 2 passes of 3 kinds
    assert len(seen) > n_warm and len(set(seen[:n_warm])) == n_warm
    assert set(seen[n_warm:]) <= set(seen[:n_warm])
