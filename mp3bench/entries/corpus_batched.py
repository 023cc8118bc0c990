"""``parallel.corpus.encode_corpus_batched``: a job's clips in one call,
stacked as lanes of the staged segment program (``args``: batch,
lookahead)."""
from mp3tpu_torch.parallel.corpus import encode_corpus_batched

from . import encoder_kwargs


def make(config, device, args):
    kw = encoder_kwargs(config)
    rate = kw.pop("sample_rate_hz")

    def encode(clips):
        outs, _ = encode_corpus_batched([(c, rate) for c in clips], kw,
                                        device, **args)
        return outs
    return encode
