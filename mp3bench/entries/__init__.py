"""The port's entry points that a window drives, one module each, found
by the ``entry`` of a traffic file.  Each has ``make(config, device,
args)``, which returns ``encode(clips) -> [stream bytes]`` for a job's
list of int16 (nch, samples) clips."""
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.tables import mpeg

MODES = {"stereo": mpeg.MODE_STEREO, "joint_stereo": mpeg.MODE_JOINT,
         "dual_channel": mpeg.MODE_DUAL, "mono": mpeg.MODE_MONO}


def encoder_kwargs(config):
    """``EncoderConfig`` keyword arguments of a configuration file."""
    return dict(layer=config["layer"], mode=MODES[config["mode"]],
                psy_model=config["psy_model"],
                bitrate_kbps=config["bitrate_kbps"],
                sample_rate_hz=float(config["sample_rate_hz"]),
                error_protection=config["crc"])


def encoder_config(config):
    return EncoderConfig(**encoder_kwargs(config))
