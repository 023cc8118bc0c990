"""The synthetic signals of the benchmark scripts (copies of
``bench.py``'s ``make_signal`` and ``bench_corpus.py``'s ``make_clip``:
the port imports neither)."""
import numpy as np


def make_signal(seconds, rate):
    """The 60 s bench signal of ``bench.py``: two tones and noise per
    channel; int16 (samples, 2)."""
    t = np.arange(int(seconds * rate)) / rate
    rng = np.random.RandomState(42)
    x = (0.35 * np.sin(2 * np.pi * 440.0 * t)
         + 0.15 * np.sin(2 * np.pi * 1871.0 * t)
         + 0.08 * rng.randn(len(t)))
    y = (0.3 * np.sin(2 * np.pi * 554.0 * t + 0.3)
         + 0.1 * rng.randn(len(t)))
    pcm = np.stack([x, y], axis=1)
    return np.clip(pcm * 24000, -32768, 32767).astype(np.int16)


def make_clip(seed, seconds, rate):
    """A corpus clip of ``bench_corpus.py``: stereo tones at a pitch set
    by the seed, and noise; int16 (2, samples)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    f0 = 200.0 + 80.0 * (seed % 13)
    x = (0.3 * np.sin(2 * np.pi * f0 * t)
         + 0.1 * np.sin(2 * np.pi * 2.7 * f0 * t)
         + 0.05 * rng.randn(len(t)))
    y = 0.25 * np.sin(2 * np.pi * 1.5 * f0 * t) + 0.05 * rng.randn(len(t))
    pcm = np.stack([x, y], axis=0)
    return np.clip(pcm * 22000, -32768, 32767).astype(np.int16)
