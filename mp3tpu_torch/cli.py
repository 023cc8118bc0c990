"""Command line of the PyTorch port: the options of ``mp3tpu``
(``mp3tpu.cli``, after the reference's musicin.c:157-296) plus
``--device``:

  python -m mp3tpu_torch [--device cuda|cpu] [-l lay][-m mode][-p psy]
         [-s sfrq][-b br][-d emp][-c][-o][-e][-L][--exact]
         inputPCM [outBS]

The parser and the input readers are the JAX package's own (its CLI
module loads no jax).  ``--device`` is explicit and defaults to cuda;
without a card that exits non-zero, it never falls back to the CPU.
``-`` reads raw interleaved PCM from stdin and streams every layer;
with no output path the bytes go to stdout.  ``--exact`` runs the
byte-exact numpy oracle and no device code.
"""
import sys

from mp3tpu.cli import (_EMPH, _MODES, build_parser, read_input,
                        stdin_pcm_iter)
from mp3tpu.config import EncoderConfig
from mp3tpu.tables import mpeg

from . import resolve_device


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
        from mp3tpu.numpy_ref.encoder import encode_layer3
        data = encode_layer3(pcm, cfg)
    elif args.layer == 3:
        from mp3tpu.runtime import profiling

        from .encoder import encode_layer3_fast
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
        from mp3tpu.numpy_ref.layer12 import encode as encode12
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
