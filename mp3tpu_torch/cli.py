"""Command line of the PyTorch port: the options of ``mp3tpu``
(``mp3tpu.cli``, after the reference's musicin.c:157-296) plus
``--device``:

  python -m mp3tpu_torch [--device cuda|cpu] [-l lay][-m mode][-p psy]
         [-s sfrq][-b br][-d emp][-c][-o][-e][-L][--exact]
         inputPCM [outBS]

The parser and the input readers are copies of the JAX package's
(``mp3tpu/cli.py``).  ``--device`` is explicit and defaults to cuda;
without a card that exits non-zero, it never falls back to the CPU.
``-`` reads raw interleaved PCM from stdin and streams every layer;
with no output path the bytes go to stdout.  ``--exact`` runs the
byte-exact numpy oracle and no device code.
"""
import argparse
import sys

import numpy as np

from . import resolve_device
from .config import EncoderConfig
from .tables import mpeg

_MODES = {"s": mpeg.MODE_STEREO, "d": mpeg.MODE_DUAL,
          "j": mpeg.MODE_JOINT, "m": mpeg.MODE_MONO}
_EMPH = {"n": 0, "5": 1, "c": 3}


def build_parser():
    p = argparse.ArgumentParser(
        prog="mp3tpu",
        description="TPU-native MPEG-1/2 audio encoder (Layers I/II/III)")
    p.add_argument("-l", dest="layer", type=int, default=3,
                   choices=(1, 2, 3), help="layer (default 3)")
    p.add_argument("-m", dest="mode", default="s", choices=sorted(_MODES),
                   help="channel mode: s/d/j/m (default s)")
    p.add_argument("-p", dest="psy", type=int, default=2, choices=(1, 2),
                   help="psychoacoustic model (default 2)")
    p.add_argument("-s", dest="sfrq", type=float, default=None,
                   help="input sample rate in kHz (overrides header)")
    p.add_argument("-b", dest="brate", type=int, default=0,
                   help="total bitrate in kbps (default: index 9)")
    p.add_argument("-d", dest="emp", default="n", choices=sorted(_EMPH),
                   help="de-emphasis n/5/c (default n)")
    p.add_argument("-c", dest="copyright", action="store_true",
                   help="mark as copyright")
    p.add_argument("-o", dest="original", action="store_true",
                   help="mark as original")
    p.add_argument("-e", dest="error_protection", action="store_true",
                   help="add CRC error protection")
    p.add_argument("-L", dest="little_endian", action="store_true",
                   help="raw PCM data is little endian")
    p.add_argument("--exact", action="store_true",
                   help="use the byte-exact oracle encoder")
    p.add_argument("input", help="WAV, AIFF, raw PCM file, or '-'")
    p.add_argument("output", nargs="?", default=None,
                   help="output stream (default: input + .mp3)")
    return p


def stdin_pcm_iter(little_endian, nch=1, chunk_bytes=1 << 20):
    """Yield (nch, n) int16 blocks from stdin until EOF -- the
    reference's 'inf' streaming mode (musicin.c:310-312) reads
    channel-interleaved PCM at the configured mode (stereo by default,
    encoder.h:64 DFLT_MOD 's'; interleaved read encode.c:139-160).
    O(chunk) memory; trailing bytes short of one interleaved frame are
    dropped like a short final fread."""
    dt = "<i2" if little_endian else ">i2"
    frame = 2 * nch
    carry = b""
    while True:
        raw = sys.stdin.buffer.read(chunk_bytes)
        if not raw:
            break
        raw = carry + raw
        usable = len(raw) - (len(raw) % frame)
        carry = raw[usable:]
        if usable:
            flat = np.frombuffer(raw[:usable], dtype=dt).astype(np.int16)
            yield flat.reshape(-1, nch).T


def _deinterleave_raw(raw, args):
    """Raw PCM is channel-interleaved at the configured mode
    (encode.c:139-160 reads `stereo` samples per frame; stereo default
    per encoder.h:64) -- returns (n, nch) int16."""
    nch = 1 if _MODES[args.mode] == mpeg.MODE_MONO else 2
    dt = "<i2" if args.little_endian else ">i2"
    flat = np.frombuffer(raw, dtype=dt).astype(np.int16)
    usable = len(flat) - (len(flat) % nch)
    return flat[:usable].reshape(-1, nch)


def read_input(args):
    """Returns (pcm int16 (n, nch), rate_hz or None)."""
    if args.input == "-":
        return _deinterleave_raw(sys.stdin.buffer.read(), args), None
    with open(args.input, "rb") as f:
        head = f.read(12)
    if head[:4] == b"FORM" and head[8:12] == b"AIFF":
        from .runtime.aiff import read_aiff
        pcm, rate = read_aiff(args.input)
        print(f">>> Using Audio IFF sound file headers ({rate:.1f} Hz)",
              file=sys.stderr)
        return pcm, rate
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        from .runtime.wav import read_wav
        pcm, rate = read_wav(args.input)
        return pcm, float(rate)
    # raw PCM
    return _deinterleave_raw(open(args.input, "rb").read(), args), None




def parser():
    p = build_parser()
    p.prog = "mp3tpu-torch"
    p.description = ("MPEG-1/2 audio encoder (Layers I/II/III), PyTorch "
                     "port on a CUDA device or the CPU")
    p.add_argument("--device", default="cuda",
                   help="torch device to encode on (default cuda)")
    return p


def _refuse_layer3(args, mode):
    """The reference's Layer III rejections; returns a message or None."""
    if args.layer != 3:
        return None
    if args.psy != 2:
        return ("psychoacoustic model 1 is not defined for layer 3 "
                "(musicin.c:554-558)")
    if mode == mpeg.MODE_JOINT:
        return "joint stereo is not defined for layer 3 (musicin.c:548-552)"
    return None


def main(argv=None):
    args = parser().parse_args(argv)
    if not args.exact:
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            return 1

    if args.input == "-" and not args.exact:
        # streaming stdin, all layers: channel-interleaved PCM at the
        # configured mode (stereo by default), O(window) memory
        rate = (args.sfrq * 1000.0) if args.sfrq is not None else 44100.0
        mode = _MODES[args.mode]
        msg = _refuse_layer3(args, mode)
        if msg:
            print(msg, file=sys.stderr)
            return 1
        cfg = EncoderConfig(
            layer=args.layer, mode=mode, psy_model=args.psy,
            bitrate_kbps=args.brate, sample_rate_hz=rate,
            emphasis=_EMPH[args.emp], copyright=args.copyright,
            original=args.original,
            error_protection=args.error_protection).finalize()
        from .encoder import encode_layer3_stream, encode_layer12_stream
        enc_stream = (encode_layer3_stream if args.layer == 3
                      else encode_layer12_stream)
        total = 0
        sink = (open(args.output, "wb") if args.output
                else sys.stdout.buffer)
        try:
            for chunk in enc_stream(
                    stdin_pcm_iter(args.little_endian, nch=cfg.nchannels),
                    cfg, args.device):
                sink.write(chunk)
                total += len(chunk)
            sink.flush()
        finally:
            if args.output:
                sink.close()
        print(f">>> streamed {total} bytes", file=sys.stderr)
        return 0

    pcm, rate = read_input(args)
    if args.sfrq is not None:
        rate = args.sfrq * 1000.0
    if rate is None:
        rate = 44100.0
    mode = _MODES[args.mode]
    nch_in = pcm.shape[1] if pcm.ndim == 2 else 1
    if nch_in == 1 and mode != mpeg.MODE_MONO:
        mode = mpeg.MODE_MONO
    if mode == mpeg.MODE_MONO and nch_in == 2:
        pcm = pcm[:, :1]
    cfg = EncoderConfig(
        layer=args.layer, mode=mode, psy_model=args.psy,
        bitrate_kbps=args.brate, sample_rate_hz=rate,
        emphasis=_EMPH[args.emp], copyright=args.copyright,
        original=args.original,
        error_protection=args.error_protection).finalize()
    out_path = args.output or (args.input + ".mp3")
    print(f">>> layer {cfg.layer}, {cfg.bitrate_kbps} kbps, "
          f"{rate / 1000.0:g} kHz, mode {args.mode}, psy {args.psy}, "
          f"{pcm.shape[0] / rate:.1f} s, device "
          f"{'numpy oracle' if args.exact else args.device}",
          file=sys.stderr)

    msg = _refuse_layer3(args, mode)
    if msg:
        print(msg, file=sys.stderr)
        return 1
    if args.layer == 3 and args.exact:
        from .numpy_ref.encoder import encode_layer3
        data = encode_layer3(pcm, cfg)
    elif args.layer == 3:
        from .encoder import encode_layer3_fast
        from .runtime import profiling
        prof = profiling.from_env()
        data = encode_layer3_fast(pcm, cfg, args.device, prof=prof)
        m = prof.meta
        # reference-style self-accounting (musicin.c:807-811)
        print(f">>> Avg slots/frame = {len(data) / max(m['frames'], 1):.2f}; "
              f"bitrate = {m['kbps']:.2f} kbps; {m['frames']} frames"
              + (f"; {m['nonfinite_granules']} granules degraded to "
                 "silence (non-finite analysis)"
                 if m["nonfinite_granules"] else ""), file=sys.stderr)
    elif args.exact:
        from .numpy_ref.layer12 import encode as encode12
        data = encode12(pcm, cfg)
    else:
        from .encoder import encode_layer12_fast
        data = encode_layer12_fast(pcm, cfg, args.device)

    with open(out_path, "wb") as f:
        f.write(data)
    print(f">>> wrote {len(data)} bytes to {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
