"""``encoder.encode_layer12_fast``: one clip a call, the Layer I/II
chain (analysis graph, K5, quantizers, marshalling, K6)."""
from mp3tpu_torch.encoder import encode_layer12_fast

from . import encoder_config


def make(config, device, args):
    cfg = encoder_config(config)

    def encode(clips):
        return [encode_layer12_fast(c, cfg, device, **args) for c in clips]
    return encode
