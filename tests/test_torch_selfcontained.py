"""The port keeps its own copies of what it needs of the JAX package's
jax-free modules and imports nothing of ``mp3tpu``.

An AST scan holds every module of ``mp3tpu_torch`` and ``chip_smoke.py``
to that; a fresh interpreter that imports every port module and encodes
Layer III, LSF and Layer II on the CPU loads no ``mp3tpu`` module; and
every copy equals its original: tables, ``EncoderConfig``, the CLI's
parser and readers, the decoders, the ``--exact`` oracles, the native
assembler, the libmpg123 binding and the profiling sink.
"""
import ast
import dataclasses
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mp3tpu_torch
from mp3tpu import cli as jcli
from mp3tpu import config as jconfig
from mp3tpu.decoder import decode_mp3 as j_decode_mp3
from mp3tpu.decoder import layer12 as j_dec12
from mp3tpu.numpy_ref import encoder as j_ref3
from mp3tpu.numpy_ref import layer12 as j_ref12
from mp3tpu.runtime import aiff as j_aiff
from mp3tpu.runtime import alloc12 as j_alloc12
from mp3tpu.runtime import bitstream as j_bitstream
from mp3tpu.runtime import mpg123 as j_mpg123
from mp3tpu.runtime import profiling as j_profiling
from mp3tpu.runtime import wav as j_wav
from mp3tpu.tables import dsp as j_dsp
from mp3tpu.tables import huffman as j_huffman
from mp3tpu.tables import layer12 as j_layer12
from mp3tpu.tables import mpeg as j_mpeg
from mp3tpu.tables import psy as j_psy
from mp3tpu_torch import cli as tcli
from mp3tpu_torch import config as tconfig
from mp3tpu_torch import encoder as tencoder
from mp3tpu_torch.decoder import decode_mp3 as t_decode_mp3
from mp3tpu_torch.decoder import layer12 as t_dec12
from mp3tpu_torch.numpy_ref import encoder as t_ref3
from mp3tpu_torch.numpy_ref import layer12 as t_ref12
from mp3tpu_torch.ops import resv as tresv
from mp3tpu_torch.runtime import aiff as t_aiff
from mp3tpu_torch.runtime import alloc12 as t_alloc12
from mp3tpu_torch.runtime import bitstream as t_bitstream
from mp3tpu_torch.runtime import mpg123 as t_mpg123
from mp3tpu_torch.runtime import profiling as t_profiling
from mp3tpu_torch.runtime import wav as t_wav
from mp3tpu_torch.tables import dsp as t_dsp
from mp3tpu_torch.tables import huffman as t_huffman
from mp3tpu_torch.tables import layer12 as t_layer12
from mp3tpu_torch.tables import mpeg as t_mpeg
from mp3tpu_torch.tables import psy as t_psy
from test_torch_lsf_standard import jax_standard_24k  # noqa: F401

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(mp3tpu_torch.__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def _absolute_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_ast_scan_finds_every_port_module():
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    for must in ("chip_smoke.py", "mp3tpu_torch/encoder.py",
                 "mp3tpu_torch/ops/bits_at.py",
                 "mp3tpu_torch/ops/search.py",
                 "mp3tpu_torch/parallel/corpus.py",
                 "mp3tpu_torch/numpy_ref/encoder.py",
                 "mp3tpu_torch/decoder/layer3.py",
                 "mp3tpu_torch/runtime/bitstream.py",
                 "mp3tpu_torch/runtime/mpg123.py",
                 "mp3tpu_torch/tools/quality.py",
                 "mp3tpu_torch/tools/bench.py",
                 "mp3tpu_torch/tools/bench_corpus.py",
                 "mp3tpu_torch/tables/huffman.py"):
        assert must in rel


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_the_jax_package_or_jax(path):
    bad = [n for n in _absolute_imports(path)
           if n.split(".")[0] in ("mp3tpu", "jax", "jaxlib", "bench",
                                   "bench_corpus")]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_fresh_interpreter_loads_no_mp3tpu_module():
    """Import every port module, encode Layer III (44.1 kHz), LSF
    (22.05 kHz) and Layer II on the CPU, then look at sys.modules."""
    mods = sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="mp3tpu_torch.") if m.name != "mp3tpu_torch.__main__")
    code = (
        "import importlib, sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from mp3tpu_torch.config import EncoderConfig\n"
        "from mp3tpu_torch.encoder import (encode_layer3_fast,"
        " encode_layer12_fast)\n"
        "from mp3tpu_torch.tables import mpeg\n"
        "rng = np.random.RandomState(0)\n"
        "pcm = (rng.randn(3 * 1152) * 3000).astype(np.int16)\n"
        "for rate, kbps in ((44100, 64), (22050, 32)):\n"
        "    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO,"
        " bitrate_kbps=kbps, sample_rate_hz=rate)\n"
        "    assert len(encode_layer3_fast(pcm, cfg, 'cpu')) > 0\n"
        "cfg = EncoderConfig(layer=2, mode=mpeg.MODE_MONO, bitrate_kbps=96,"
        " sample_rate_hz=44100)\n"
        "assert len(encode_layer12_fast(pcm[:, None], cfg, 'cpu')) > 0\n"
        "bad = sorted(k for k in sys.modules if k == 'mp3tpu'"
        " or k.startswith('mp3tpu.') or k == 'jax'"
        " or k.startswith('jax.'))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout


# ---------------------------------------------------------------------------
# the copies equal their originals
# ---------------------------------------------------------------------------

def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


def _values(mod):
    """A tables module's numpy arrays, ints, floats and containers."""
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__")
            and isinstance(v, (np.ndarray, int, float, np.integer,
                               np.floating, list, tuple, dict))}


TABLES = [(j_mpeg, t_mpeg), (j_huffman, t_huffman), (j_dsp, t_dsp),
          (j_psy, t_psy), (j_layer12, t_layer12)]


@pytest.mark.parametrize("pair", TABLES,
                         ids=[j.__name__.split(".")[-1] for j, _ in TABLES])
def test_table_module_values_equal(pair, jax_standard_24k):
    jmod, tmod = pair
    jv, tv = _values(jmod), _values(tmod)
    assert jv.keys() == tv.keys()
    assert any(isinstance(v, np.ndarray) for v in jv.values())
    for k in jv:
        assert _equal(jv[k], tv[k]), k


def test_huff_fields_equal():
    for f in dataclasses.fields(j_huffman.HUFF):
        a = getattr(j_huffman.HUFF, f.name)
        b = getattr(t_huffman.HUFF, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    for which in (0, 1):
        assert np.array_equal(j_huffman.HUFF.count1_hlen(which),
                              t_huffman.HUFF.count1_hlen(which))


def test_psy_params_equal(jax_standard_24k):
    for rate in (16000, 22050, 24000, 32000, 44100, 48000):
        assert _equal(j_psy.psy_params_for_sfreq(rate),
                      t_psy.psy_params_for_sfreq(rate)), rate


def _finalized(cls, **kw):
    try:
        return dataclasses.asdict(cls(**kw).finalize())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("layer", [1, 2, 3])
def test_encoder_config_finalize_equal(layer):
    n = 0
    for rate in (16000, 22050, 24000, 32000, 44100, 48000, 11025):
        for kbps in (0, 8, 32, 64, 96, 128, 192, 320, 448):
            for mode in (0, 1, 2, 3):
                kw = dict(layer=layer, mode=mode, bitrate_kbps=kbps,
                          sample_rate_hz=rate)
                a = _finalized(jconfig.EncoderConfig, **kw)
                assert a == _finalized(tconfig.EncoderConfig, **kw), kw
                n += isinstance(a, dict)
                if isinstance(a, dict):
                    j = jconfig.EncoderConfig(**kw).finalize()
                    t = tconfig.EncoderConfig(**kw).finalize()
                    assert (j.slots_per_frame() == t.slots_per_frame()
                            and j.mode_gr == t.mode_gr
                            and j.samples_per_frame == t.samples_per_frame)
    assert n > 50


ARGVS = [
    ["in.wav"],
    ["in.wav", "out.mp3"],
    ["-l", "2", "-m", "j", "-b", "192", "-e", "in.wav"],
    ["-l", "1", "-m", "m", "-p", "1", "-d", "5", "-c", "-o", "x.aiff"],
    ["-s", "22.05", "-b", "64", "-L", "-", "o.mp3"],
    ["--exact", "-m", "d", "-d", "c", "in.raw"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_parser_equal(argv):
    assert (vars(jcli.build_parser().parse_args(argv))
            == vars(tcli.build_parser().parse_args(argv)))
    assert jcli._MODES == tcli._MODES and jcli._EMPH == tcli._EMPH


def test_parser_refuses_what_the_original_refuses():
    for argv in (["-l", "4", "x"], ["-m", "q", "x"], []):
        for parser in (jcli.build_parser(), tcli.build_parser()):
            with pytest.raises(SystemExit):
                parser.parse_args(argv)


def test_input_readers_equal(tmp_path):
    rng = np.random.RandomState(3)
    pcm = (rng.randn(1000, 2) * 2000).astype(np.int16)
    wav = str(tmp_path / "a.wav")
    t_wav.write_wav(wav, pcm, 32000)
    j_wav.write_wav(str(tmp_path / "b.wav"), pcm, 32000)
    assert open(wav, "rb").read() == open(tmp_path / "b.wav", "rb").read()
    raw = str(tmp_path / "a.raw")
    pcm.astype(">i2").tofile(raw)
    for argv in ([wav], ["-m", "m", raw], ["-L", raw], [raw]):
        ja = jcli.build_parser().parse_args(argv)
        ta = tcli.build_parser().parse_args(argv)
        jp, jr = jcli.read_input(ja)
        tp, tr = tcli.read_input(ta)
        assert jr == tr and jp.dtype == tp.dtype and np.array_equal(jp, tp)
    assert _equal(j_wav.read_wav_refcompat(wav), t_wav.read_wav_refcompat(wav))


def test_aiff_reader_equal(tmp_path):
    import struct
    pcm = (np.random.RandomState(4).randn(500, 2) * 1000).astype(np.int16)
    ssnd = struct.pack(">II", 0, 0) + pcm.astype(">i2").tobytes()
    # 44100 Hz as an IEEE 754 80-bit extended float
    rate80 = bytes.fromhex("400EAC44000000000000")
    comm = struct.pack(">hIh", 2, len(pcm), 16) + rate80
    body = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    path = str(tmp_path / "a.aiff")
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)
    jp, jr = j_aiff.read_aiff(path)
    tp, tr = t_aiff.read_aiff(path)
    assert jr == tr == 44100.0 and np.array_equal(jp, tp)
    assert np.array_equal(tp, pcm)


@pytest.mark.parametrize("name", ["sine_mono_64", "noise_st_128"])
def test_layer3_decoder_equal(name):
    with open(os.path.join(GOLDEN, f"{name}.ref.mp3"), "rb") as f:
        data = f.read()
    (jp, jr), (tp, tr) = j_decode_mp3(data), t_decode_mp3(data)
    assert jr == tr and jp.dtype == tp.dtype and np.array_equal(jp, tp)
    assert jp.shape[0] > 1152


@pytest.mark.parametrize("name", ["l2_sine_st_192.ref.mp2",
                                  "l1_sine_st_384.ref.mp1"])
def test_layer12_decoder_equal(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        data = f.read()
    (jp, jr), (tp, tr) = j_dec12.decode(data), t_dec12.decode(data)
    assert jr == tr and jp.dtype == tp.dtype and np.array_equal(jp, tp)
    assert jp.shape[0] > 1152


def _quarter_second(name):
    pcm, rate = t_wav.read_wav(os.path.join(GOLDEN, f"{name}.wav"))
    return pcm[:rate // 4], rate


def test_exact_layer3_oracle_equal():
    pcm, rate = _quarter_second("q_sine_mono_64")
    kw = dict(layer=3, mode=t_mpeg.MODE_MONO, bitrate_kbps=64,
              sample_rate_hz=rate)
    a = j_ref3.encode_layer3(pcm[:, 0], jconfig.EncoderConfig(**kw))
    b = t_ref3.encode_layer3(pcm[:, 0], tconfig.EncoderConfig(**kw))
    assert len(a) > 400 and a == b


def test_exact_layer2_oracle_equal():
    pcm, rate = _quarter_second("l2_sine_st_192")
    kw = dict(layer=2, mode=t_mpeg.MODE_STEREO, bitrate_kbps=192,
              sample_rate_hz=rate, error_protection=True)
    a = j_ref12.encode(pcm, jconfig.EncoderConfig(**kw))
    b = t_ref12.encode(pcm, tconfig.EncoderConfig(**kw))
    assert len(a) > 4000 and a == b


def test_native_assembler_stream_equal(monkeypatch):
    """One CPU encode through the port's assembler, guard and scan, and
    the same encode through the JAX package's: the same bytes."""
    rng = np.random.RandomState(7)
    pcm = (rng.randn(6 * 1152, 2) * 4000).astype(np.int16)
    cfg = tconfig.EncoderConfig(layer=3, mode=t_mpeg.MODE_STEREO,
                                bitrate_kbps=128, sample_rate_hz=44100)
    ours = tencoder.encode_layer3_fast(pcm, cfg, "cpu")
    for name in ("NativeAssembler", "resv_guard", "guard_clamp"):
        monkeypatch.setattr(tencoder, name, getattr(j_bitstream, name))
    monkeypatch.setattr(tresv, "resv_scan", j_bitstream.resv_scan)
    theirs = tencoder.encode_layer3_fast(pcm, cfg, "cpu")
    assert len(ours) > 6 * 417 and ours == theirs


def test_bitstream_helpers_equal():
    rng = np.random.RandomState(8)
    values = rng.randint(0, 1 << 16, size=500).astype(np.uint32)
    lengths = rng.randint(0, 17, size=500).astype(np.int32)
    assert _equal(j_bitstream.pack_elements(values, lengths),
                  t_bitstream.pack_elements(values, lengths))
    # 20 stereo MPEG-1 frames at 128 kbps: (nch, G) granule arrays
    p23 = rng.randint(0, 2400, size=(2, 40)).astype(np.int64)
    pe = rng.rand(2, 40) * 3000
    demand = rng.randint(0, 2400, size=(2, 40)).astype(np.int64)
    for args in ((p23, 20, 2, 3344, 4088), (p23, 20, 2, 3344, 4088, 2, 99)):
        assert _equal(j_bitstream.resv_guard(*args),
                      t_bitstream.resv_guard(*args))
    for kw in ({}, {"size": 123}, {"delta": 40}):
        assert _equal(j_bitstream.resv_scan(pe, demand, None, None, 20, 2,
                                            3344, 4088, **kw),
                      t_bitstream.resv_scan(pe, demand, None, None, 20, 2,
                                            3344, 4088, **kw))


def test_alloc12_module_equal():
    jv = {k: v for k, v in vars(j_alloc12).items()
          if not k.startswith("__") and not callable(v)
          and not isinstance(v, type(np))}
    tv = {k: v for k, v in vars(t_alloc12).items()
          if not k.startswith("__") and not callable(v)
          and not isinstance(v, type(np))}
    assert jv.keys() == tv.keys()
    for k in jv:
        assert _equal(jv[k], tv[k]), k
    fns = sorted(k for k, v in vars(j_alloc12).items()
                 if callable(v) and getattr(v, "__module__", "")
                 == j_alloc12.__name__)
    assert fns == sorted(k for k, v in vars(t_alloc12).items()
                         if callable(v) and getattr(v, "__module__", "")
                         == t_alloc12.__name__)
    for k in fns:
        assert (getattr(j_alloc12, k).__code__.co_code
                == getattr(t_alloc12, k).__code__.co_code), k


def test_profiling_sink_equal(monkeypatch):
    for mod in (j_profiling, t_profiling):
        monkeypatch.delenv("MP3TPU_PROFILE", raising=False)
        assert type(mod.from_env()).__name__ == "_Null"
        assert mod.from_env() is not mod.from_env()
        monkeypatch.setenv("MP3TPU_PROFILE", "1")
        p = mod.from_env()
        assert type(p).__name__ == "Profiler"
        with p.stage("a"):
            pass
        assert set(p.stages) == {"a"} and p.meta == {}
        with mod.NULL.stage("b"):
            pass
    # the port adds trace() (on torch.profiler) and the named spans; the
    # four copied names stay as they are in the original
    assert callable(t_profiling.trace) and callable(t_profiling.span)
    for name in ("Profiler", "_Null", "from_env"):
        assert (inspect.getsource(getattr(j_profiling, name))
                == inspect.getsource(getattr(t_profiling, name))), name
    assert type(t_profiling.NULL).__name__ == "_Null"


def test_mpg123_binding_equal():
    """The binding is a byte copy (it imports nothing of the package);
    where libmpg123 is present both decode a golden stream alike."""
    with open(j_mpg123.__file__) as a, open(t_mpg123.__file__) as b:
        assert a.read() == b.read()
    assert j_mpg123.available() == t_mpg123.available()
    if t_mpg123.available():
        with open(os.path.join(GOLDEN, "noise_st_128.ref.mp3"), "rb") as f:
            data = f.read()
        (jp, jr), (tp, tr) = j_mpg123.decode(data), t_mpg123.decode(data)
        assert jr == tr and np.array_equal(jp, tp) and jp.shape[0] > 1152
