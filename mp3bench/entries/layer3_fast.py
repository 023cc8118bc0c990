"""``encoder.encode_layer3_fast``: one clip a call, the one-shot Layer
III encode (the segment program as one CUDA graph a key)."""
from mp3tpu_torch.encoder import encode_layer3_fast

from . import encoder_config


def make(config, device, args):
    cfg = encoder_config(config)

    def encode(clips):
        return [encode_layer3_fast(c, cfg, device, **args) for c in clips]
    return encode
