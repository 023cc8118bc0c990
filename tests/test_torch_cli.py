"""The port's command line (python -m mp3tpu_torch) on the CPU.

The stdin streaming cases of tests/test_cli_stream.py with --device cpu;
file encodes whose bytes equal the library's; the reference's Layer III
rejections; no silent fall back to the CPU when --device cuda finds no
card.
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mp3tpu.decoder import decode_mp3
from mp3tpu.runtime.wav import write_wav
from mp3tpu.tables import mpeg
from mp3tpu_torch import cli
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.encoder import encode_layer3_fast, encode_layer12_fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)


def _stdin(monkeypatch, payload):
    monkeypatch.setattr("sys.stdin",
                        type("S", (), {"buffer": io.BytesIO(payload)})())


def _tone(seconds, rate=44100):
    t = np.arange(int(seconds * rate)) / rate
    return np.clip(0.3 * np.sin(2 * np.pi * 440 * t) * 22000,
                   -32768, 32767)


def test_cli_streams_stdin(tmp_path, monkeypatch):
    x = _tone(1.2).astype(">i2")                     # raw big-endian mono
    _stdin(monkeypatch, x.tobytes())
    out = tmp_path / "out.mp3"
    rc = cli.main(["--device", "cpu", "-m", "m", "-b", "64", "-s", "44.1",
                   "-", str(out)])
    assert rc == 0
    data = out.read_bytes()
    assert data[0] == 0xFF
    dec, r = decode_mp3(data)
    assert r == 44100 and dec.shape[0] >= len(x) - 1152


def test_cli_streams_stdin_stereo(tmp_path, monkeypatch):
    """Stereo-interleaved pipe at the default mode: the channels stay
    separated."""
    rate = 44100
    n = int(1.2 * rate)
    t = np.arange(n) / rate
    inter = np.empty(2 * n)
    inter[0::2] = 0.4 * np.sin(2 * np.pi * 440 * t)
    inter[1::2] = 0.004 * np.sin(2 * np.pi * 3000 * t)   # near-silent
    pcm = np.clip(inter * 32767, -32768, 32767).astype(">i2")
    _stdin(monkeypatch, pcm.tobytes())
    out = tmp_path / "out.mp3"
    rc = cli.main(["--device", "cpu", "-b", "128", "-s", "44.1", "-",
                   str(out)])
    assert rc == 0
    dec, r = decode_mp3(out.read_bytes())
    assert r == rate and dec.ndim == 2 and dec.shape[1] == 2
    e0 = float(np.mean(dec[:, 0].astype(np.float64) ** 2))
    e1 = float(np.mean(dec[:, 1].astype(np.float64) ** 2))
    assert e0 > 1000.0 * max(e1, 1e-12), (e0, e1)


def test_cli_stream_stdout(monkeypatch):
    """No output argument: MP3 bytes go to stdout."""
    x = _tone(0.4).astype(">i2")
    _stdin(monkeypatch, x.tobytes())
    sink = io.BytesIO()
    monkeypatch.setattr("sys.stdout",
                        type("O", (), {"buffer": sink,
                                       "flush": lambda self=None: None})())
    rc = cli.main(["--device", "cpu", "-m", "m", "-b", "64", "-s", "44.1",
                   "-"])
    assert rc == 0
    data = sink.getvalue()
    assert len(data) > 1000 and data[0] == 0xFF


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    rng = np.random.RandomState(4)
    n = int(1.5 * 44100)
    pcm = np.stack([_tone(1.5), 0.5 * _tone(1.5) + 900 * rng.randn(n)], 1)
    pcm = np.clip(pcm, -32768, 32767).astype(np.int16)
    path = tmp_path_factory.mktemp("cli") / "in.wav"
    write_wav(str(path), pcm, 44100)
    return str(path), pcm


@pytest.mark.parametrize("layer,kbps", [(3, 128), (2, 192)])
def test_cli_file_equals_library(tmp_path, wav, layer, kbps):
    path, pcm = wav
    out = tmp_path / "out.mp3"
    rc = cli.main(["--device", "cpu", "-l", str(layer), "-b", str(kbps),
                   path, str(out)])
    assert rc == 0
    cfg = EncoderConfig(layer=layer, mode=mpeg.MODE_STEREO,
                        bitrate_kbps=kbps, sample_rate_hz=44100)
    lib = (encode_layer3_fast(pcm, cfg, "cpu") if layer == 3
           else encode_layer12_fast(pcm, cfg, "cpu"))
    assert out.read_bytes() == lib


@pytest.mark.parametrize("opts", [["-m", "j"], ["-p", "1"]],
                         ids=["joint", "psy1"])
@pytest.mark.parametrize("stdin", [False, True], ids=["file", "stdin"])
def test_cli_refuses_layer3_joint_and_psy1(tmp_path, monkeypatch, wav, opts,
                                           stdin):
    out = tmp_path / "out.mp3"
    if stdin:
        _stdin(monkeypatch, _tone(0.2).astype(">i2").tobytes())
        rc = cli.main(["--device", "cpu"] + opts + ["-", str(out)])
    else:
        rc = cli.main(["--device", "cpu"] + opts + [wav[0], str(out)])
    assert rc == 1
    assert not out.exists()


def test_cli_cuda_without_card_fails(tmp_path, wav, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "out.mp3"
    rc = cli.main(["--device", "cuda", wav[0], str(out)])
    assert rc != 0 and not out.exists()
    assert "CUDA" in capsys.readouterr().err


def test_python_m_runs_without_jax(tmp_path, wav):
    """python -m mp3tpu_torch encodes, and the process never loads jax."""
    out = tmp_path / "out.mp3"
    code = ("import runpy, sys\n"
            "sys.argv = ['mp3tpu_torch', '--device', 'cpu', '-l', '2', "
            f"'-b', '192', {wav[0]!r}, {str(out)!r}]\n"
            "try:\n"
            "    runpy.run_module('mp3tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
    assert out.read_bytes()[0] == 0xFF
