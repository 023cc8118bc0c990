"""Streaming Layer III in the port: StreamEncoder and encode_layer3_stream
on the CPU, after tests/test_stream.py and tests/test_recovery.py.

The reservoir scan, the guard and the assembler weave are causal, so
windows with carried state give the one-shot bytes exactly when the
windows and the one-shot plan have the same segment shapes
(window == chunk): the same segment programs run on the same inputs.
A checkpoint holds numpy and Python values only and survives pickle.
"""
import pickle

import numpy as np
import pytest
import torch

from mp3tpu.tables import mpeg
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.encoder import (StreamEncoder, encode_layer3_fast,
                                  encode_layer3_stream)

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)


def _signal(seconds, rate=44100, stereo=False, seed=3):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(len(t))
    pos = int(0.4 * len(t))
    x[pos:pos + 300] += 0.4 * np.hanning(300)[:len(x) - pos]
    pcm = np.stack([x, 0.8 * x]) if stereo else x[None, :]
    return np.clip(pcm * 22000, -32768, 32767).astype(np.int16)


def _pieces(pcm, piece):
    for s in range(0, pcm.shape[1], piece):
        yield pcm[:, s:s + piece]


def _cfg(mode=mpeg.MODE_MONO, kbps=64, rate=44100):
    return EncoderConfig(layer=3, mode=mode, bitrate_kbps=kbps,
                         sample_rate_hz=rate)


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_stream_matches_oneshot(stereo):
    pcm = _signal(4.5, stereo=stereo)
    mode = mpeg.MODE_STEREO if stereo else mpeg.MODE_MONO
    one = encode_layer3_fast(pcm, _cfg(mode, 96), "cpu", chunk=128)
    streamed = b"".join(encode_layer3_stream(_pieces(pcm, 10_000),
                                             _cfg(mode, 96), "cpu",
                                             window=128))
    assert streamed == one


def test_stream_lsf():
    """The MPEG-2 LSF path (one granule per frame) streams too."""
    pcm = _signal(2.0, rate=22050)
    one = encode_layer3_fast(pcm, _cfg(kbps=32, rate=22050), "cpu",
                             chunk=64)
    streamed = b"".join(encode_layer3_stream(
        _pieces(pcm, 10_000), _cfg(kbps=32, rate=22050), "cpu", window=64))
    assert streamed == one


def test_checkpoint_resume_identical_stream():
    """Stop half way, pickle the carry, resume in a fresh encoder: the
    concatenated output equals an uninterrupted run."""
    pcm = _signal(4.0)
    enc = StreamEncoder(_cfg(), "cpu", window=64)
    whole = enc.feed(pcm) + enc.finish()

    enc1 = StreamEncoder(_cfg(), "cpu", window=64)
    cut = pcm.shape[1] // 2
    part1 = enc1.feed(pcm[:, :cut])
    ckpt = enc1.checkpoint()
    for k, v in ckpt.items():
        assert not isinstance(v, torch.Tensor), k
    blob = pickle.dumps(ckpt)
    del enc1
    enc2 = StreamEncoder.resume(_cfg(), pickle.loads(blob), "cpu", window=64)
    part2 = enc2.feed(pcm[:, cut:]) + enc2.finish()
    assert part1 + part2 == whole


def test_frames_flow_out_incrementally():
    """Windows stream out as they complete, not all at the end."""
    pcm = _signal(6.0)
    sizes = [len(c) for c in encode_layer3_stream(_pieces(pcm, 20_000),
                                                  _cfg(), "cpu", window=64)]
    assert len(sizes) > 3
    assert sum(sizes[:-1]) > 0.5 * sum(sizes)


def test_final_single_sample_piece_is_not_transposed():
    """A final (nch, 1) piece keeps its orientation."""
    pcm = _signal(0.3, stereo=True)
    one = encode_layer3_fast(pcm, _cfg(mpeg.MODE_STEREO, 128), "cpu",
                             chunk=64)
    pieces = [pcm[:, :-1], pcm[:, -1:]]
    streamed = b"".join(encode_layer3_stream(
        pieces, _cfg(mpeg.MODE_STEREO, 128), "cpu", window=64))
    assert streamed == one
